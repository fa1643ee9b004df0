"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

Same sub-package and module names as the JAX reference so a reader finds
the counterpart; this package imports ``torch`` only — nothing of ``jax``
and nothing of ``repro``.  Ported so far: the continuous-batching serving
path on the dense transformer and RWKV-6 families (``launch/serve.py`` →
``serve/continuous.py`` → ``serve/step.py`` → ``serve/paged.py`` →
``models/*``) and the training path with int8-compressed gradient
reduction over emulated pods (``launch/train.py`` → ``train/loop.py`` →
``train/step.py`` → ``parallel/collectives.py``), with every Pallas
kernel of the reference rewritten by hand for Hopper (``csrc/*.cu``).
"""
