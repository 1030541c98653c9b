"""Observability: span tracing, metrics and plan cost attribution, copied
from ``repro.obs``.

Three standard-library layers:

  * :mod:`repro_torch.obs.trace` — nested context-manager span tracer with
    thread-safe counters, exporting Chrome-trace-event JSON that loads
    directly into Perfetto (``ui.perfetto.dev``) or ``chrome://tracing``.
    Off by default and near-free when off; enabled via env
    ``REPRO_TORCH_TRACE=/path.json`` or ``trace.enable(path)``.
  * :mod:`repro_torch.obs.metrics` — a process-wide registry of counters,
    gauges and histograms with JSON snapshot export, plus run-provenance
    capture (git sha, torch and CUDA versions, the device, hostname, wall
    clock) stamped into calibration registry entries and traces.

  * :mod:`repro_torch.obs.explain` — the attribution layer:
    ``plan_grid(..., explain=True)`` / the planner CLI's ``--explain``
    decompose each surviving candidate's projected step time into additive
    terms (compute, memory, per-axis α·steps vs bytes/bw network, pipeline
    bubble, ZeRO sync) and report structured prune reasons.
"""
from repro_torch.obs import explain, metrics, trace  # noqa: F401
from repro_torch.obs.metrics import REGISTRY, provenance  # noqa: F401
from repro_torch.obs.trace import count, enabled, span  # noqa: F401

__all__ = ["trace", "metrics", "explain", "span", "count", "enabled", "REGISTRY",
           "provenance"]
