"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
with launch counters, and the plain PyTorch versions (``ref``)."""
