"""Hand-written CUDA kernels (``csrc/``: the blocked matmul and the flash
attention), their wrappers (``blocked_matmul``, ``flash_attention``), and
the plain PyTorch versions they are checked against (``ref``).  ``ops`` is
the dispatch layer the models call."""
