"""Hand-written Hopper kernels of the port: one module per kernel (wrapper +
plain PyTorch version), ``ref.py`` oracles, ``ops.py`` dispatch, ``_build.py``
compiling ``../csrc/*.cu`` with nvcc at first use."""
