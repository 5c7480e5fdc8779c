"""Hand-written CUDA kernels (``csrc/``), their launch wrappers, the plain
PyTorch versions (``ref``) and the public dispatching wrappers (``ops``)."""
