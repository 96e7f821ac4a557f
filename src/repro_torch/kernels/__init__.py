"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers and
plain PyTorch versions.  Dispatch by device lives in ``kernels.ops``."""
