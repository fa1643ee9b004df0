"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

Same sub-package and module names as the JAX reference so a reader finds
the counterpart; this package imports ``torch`` only — nothing of ``jax``
and nothing of ``repro``.  Ported so far: the paged continuous-batching
serving path on the dense transformer family (``launch/serve.py`` →
``serve/continuous.py`` → ``serve/step.py`` → ``serve/paged.py`` →
``models/*``) with its two hand-written Hopper kernels
(``csrc/paged_attention.cu``, ``csrc/flash_attention.cu``).
"""
