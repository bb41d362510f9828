"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers, and the
plain PyTorch versions the CPU path runs.  Nothing is built at import."""
