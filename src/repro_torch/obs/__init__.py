"""Observability: span tracing and metrics, copied from ``repro.obs``.

Two standard-library layers:

  * :mod:`repro_torch.obs.trace` — nested context-manager span tracer with
    thread-safe counters, exporting Chrome-trace-event JSON that loads
    directly into Perfetto (``ui.perfetto.dev``) or ``chrome://tracing``.
    Off by default and near-free when off; enabled via env
    ``REPRO_TORCH_TRACE=/path.json`` or ``trace.enable(path)``.
  * :mod:`repro_torch.obs.metrics` — a process-wide registry of counters,
    gauges and histograms with JSON snapshot export, plus run-provenance
    capture (git sha, torch and CUDA versions, the device, hostname, wall
    clock) stamped into calibration registry entries and traces.

The reference's third layer, ``obs.explain`` (the planner's cost
attribution), comes with the planner (ROADMAP Queue 1 item 12).
"""
from repro_torch.obs import metrics, trace  # noqa: F401  (import surface)
from repro_torch.obs.metrics import REGISTRY, provenance  # noqa: F401
from repro_torch.obs.trace import count, enabled, span  # noqa: F401

__all__ = ["trace", "metrics", "span", "count", "enabled", "REGISTRY",
           "provenance"]
