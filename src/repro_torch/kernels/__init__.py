"""Hand-written CUDA kernels (``csrc/``), their wrappers, and the plain
PyTorch versions they are checked against (``ref``).  ``ops`` is the
dispatch layer the models call."""
