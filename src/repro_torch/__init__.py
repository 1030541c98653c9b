"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Subpackages mirror ``repro``'s names so each module has a visible
counterpart:

  configs   the architecture registry (data only)
  models    ``ModelConfig``, the DLRM MLP tower and the dense decoder's
            train / prefill forward
  kernels   hand-written CUDA kernels, their plain PyTorch versions, and
            the dispatch layer (``ops``)
  core      ``HardwareSpec`` (H100 datasheet presets) and the Ridgeline model
  measure   timers and sized microbenchmarks

The package imports ``torch``, numpy and the standard library only: never
``jax`` and never ``repro``.  Every entry point takes ``device=None``, which
means the CUDA card; with no card it raises (see :mod:`repro_torch.device`).
"""
from repro_torch.device import resolve_device  # noqa: F401
