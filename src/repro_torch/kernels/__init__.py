"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the checked public wrappers in ``ops``."""
