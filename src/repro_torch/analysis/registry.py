"""Unit declarations for the real `repro_torch` API surface.

The units lint is only as good as its seed facts.  This registry declares,
once, what the cost model's quantities *are*:

- ``ATTR_UNITS``   — attribute accesses (``work.flops``, ``hw.peak_flops``,
  ``cost.wire_bytes``) whose unit is fixed by the owning dataclass.  Keyed
  by bare attribute name, so only attributes whose unit is unambiguous
  across the whole tree belong here (that invariant is itself part of the
  discipline: the reference renamed ``ExplainTerms``'s seconds-valued
  ``*_bytes`` fields rather than whitelist the collision).
- ``RETURN_UNITS`` — functions/methods whose return unit is fixed
  (``bandwidth_for`` → bytes/s, ``resource_times`` → (s, s, s)).
- ``PARAM_UNITS``  — per-function parameter units, checked at call sites
  when the callee name matches.
- ``SUFFIX_UNITS`` — naming conventions (``*_bytes``, ``*_bw``, ``*_s``)
  that act as *declarations* on local names: a name carrying a suffix is
  assumed to hold that unit, and a concrete inferred unit that contradicts
  the suffix is a finding.  Scale suffixes (``_gb``, ``_ms``, ``_us``) map
  to :data:`EXCLUDED` — same dimension, different scale, so the linter
  stays silent rather than blessing e.g. GB as bytes.

New modules extend these dicts (or ship a module-level ``__repro_units__``
mapping, picked up by the linter) rather than sprinkling suppressions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .units import (BYTES, BYTES_PER_S, DIMENSIONLESS, FLOPS, FLOPS_PER_S,
                    SECONDS, Unit)

__all__ = ["ATTR_UNITS", "RETURN_UNITS", "PARAM_UNITS", "SUFFIX_UNITS",
           "NAME_UNITS", "EXCLUDED", "name_unit", "suffix_unit"]

#: sentinel: a name the linter must treat as unknown (scale-shifted units)
EXCLUDED = object()

# --- attribute declarations ---------------------------------------------------
# core/ridgeline.WorkUnit, measure/microbench.WorkUnit, core/hardware
# .HardwareSpec, distributed/collectives.CollectiveCost, core/sweep
# .SweepResult, launch/memory.WorkingSet, launch/plan_grid.GridResult /
# ExplainTerms.  Keep every entry tree-unambiguous (see module docstring).
ATTR_UNITS: Dict[str, Unit] = {
    # work (FLOPs)
    "flops": FLOPS,
    "comp_flops_s": SECONDS,          # ExplainTerms: seconds of flop time
    # bytes — traffic, footprints, capacities
    "mem_bytes": BYTES,
    "net_bytes": BYTES,
    "bytes_mem": BYTES,
    "bytes_net": BYTES,
    "wire_bytes": BYTES,
    "hbm_capacity_bytes": BYTES,
    "vmem_bytes": BYTES,
    "act_bytes": BYTES,
    "params": BYTES,                  # WorkingSet fields are bytes
    "grads": BYTES,
    "opt": BYTES,
    "activations": BYTES,
    "kv_cache": BYTES,
    "hbm_used_bytes": BYTES,
    "persisted": BYTES,               # WorkingSet: bytes a checkpoint writes
    # rates
    "peak_flops": FLOPS_PER_S,
    "hbm_bw": BYTES_PER_S,
    "net_bw": BYTES_PER_S,
    "ckpt_bw": BYTES_PER_S,
    # seconds
    "alpha_compute": SECONDS,
    "alpha_memory": SECONDS,
    "alpha_network": SECONDS,
    "t_compute": SECONDS,
    "t_memory": SECONDS,
    "t_network": SECONDS,
    "runtime": SECONDS,
    "best_seconds": SECONDS,
    "seconds": SECONDS,
    "comp_alpha_s": SECONDS,
    "mem_alpha_s": SECONDS,
    "mem_bytes_s": SECONDS,
    "net_dp_alpha_s": SECONDS,
    "net_dp_bytes_s": SECONDS,
    "net_tp_alpha_s": SECONDS,
    "net_tp_bytes_s": SECONDS,
    "net_pp_alpha_s": SECONDS,
    "net_pp_bytes_s": SECONDS,
    "net_ep_alpha_s": SECONDS,
    "net_ep_bytes_s": SECONDS,
    # resilience (FailureModel, MeshPlan goodput fields, VirtualCosts)
    "mtbf_chip_s": SECONDS,
    "restart_s": SECONDS,
    "reshard_s": SECONDS,
    "downtime_s": SECONDS,
    "ckpt_overhead_s": SECONDS,
    "rework_s": SECONDS,
    "ckpt_interval_s": SECONDS,
    "t_step_s": SECONDS,
    "t_ckpt_s": SECONDS,
    "wall_s": SECONDS,
    "useful_s": SECONDS,
    "backoff_base_s": SECONDS,
    "backoff_max_s": SECONDS,
    # dimensionless
    "net_steps": DIMENSIONLESS,
    "steps": DIMENSIONLESS,
    "compute_eff": DIMENSIONLESS,
    "model_rel_error": DIMENSIONLESS,
    "rel_spread": DIMENSIONLESS,
    "goodput": DIMENSIONLESS,
    "backoff_jitter": DIMENSIONLESS,
}

# --- return-unit declarations -------------------------------------------------
# Keyed by bare callee name (function or method).  A tuple value declares a
# tuple return, element-wise; None elements are unknown.
RETURN_UNITS: Dict[str, object] = {
    "bandwidth_for": BYTES_PER_S,
    "alpha_for": SECONDS,
    "effective_peak": FLOPS_PER_S,
    "resource_times": (SECONDS, SECONDS, SECONDS),
    "param_counts": (DIMENSIONLESS, DIMENSIONLESS),
    "expert_param_counts": (DIMENSIONLESS, DIMENSIONLESS),
    "best_all_reduce_grid": (BYTES, DIMENSIONLESS, None),
    "zero_dp_sync": None,             # returns CollectiveCost (object)
    "ep_dispatch_combine": None,      # returns CollectiveCost (object)
    "moe_routing_derate": DIMENSIONLESS,
    "pp_boundary_bytes": BYTES,
    "eff": DIMENSIONLESS,
    "eff_grid": DIMENSIONLESS,
    "time": SECONDS,                  # CollectiveCost.time / time.time
    "perf_counter": SECONDS,
    "training_working_set": None,     # WorkingSet object
    "decode_working_set": None,
    "total": BYTES,                   # WorkingSet.total property-as-call
    # resilience.failures kernels
    "mesh_mtbf_s": SECONDS,
    "ckpt_time_s": SECONDS,
    "young_daly_interval_s": SECONDS,
    "failure_overhead_terms": (SECONDS, SECONDS, SECONDS),
    "goodput_fraction": DIMENSIONLESS,
    "goodput_terms": (SECONDS, SECONDS, SECONDS, SECONDS, DIMENSIONLESS),
    "predicted_goodput": DIMENSIONLESS,
    "goodput_analytic": DIMENSIONLESS,
}

# --- parameter declarations ---------------------------------------------------
# Per-callee (name, unit) pairs in positional order; unit None = unchecked.
# Checked at call sites for both positional and keyword arguments.
_COLLECTIVE_ARGS: Tuple[Tuple[str, Optional[Unit]], ...] = (
    ("payload_bytes", BYTES), ("group_size", DIMENSIONLESS))
PARAM_UNITS: Dict[str, Tuple[Tuple[str, Optional[Unit]], ...]] = {
    "all_reduce": _COLLECTIVE_ARGS,
    "reduce_scatter": _COLLECTIVE_ARGS,
    "all_gather": _COLLECTIVE_ARGS,
    "all_to_all": _COLLECTIVE_ARGS,
    "best_all_reduce_grid": (
        ("payload_bytes", BYTES), ("group_size", DIMENSIONLESS),
        ("bw", BYTES_PER_S), ("alpha", SECONDS)),
    "zero_dp_sync": (("state_bytes_per_chip", BYTES), ("dp", DIMENSIONLESS),
                     ("stage", DIMENSIONLESS)),
    "pp_boundary_bytes": (("act_bytes", BYTES), ("pp", DIMENSIONLESS)),
    "ep_dispatch_combine": (("payload_bytes", BYTES),
                            ("ep", DIMENSIONLESS)),
    "moe_routing_derate": (("ep", DIMENSIONLESS),
                           ("tokens_mb", DIMENSIONLESS)),
    "time": (("link_bw", BYTES_PER_S), ("alpha", SECONDS)),
    "mesh_mtbf_s": (("chips", DIMENSIONLESS), ("mtbf_chip_s", SECONDS)),
    "ckpt_time_s": (("persisted_bytes", BYTES), ("ckpt_bw", BYTES_PER_S)),
    "young_daly_interval_s": (("t_ckpt_s", SECONDS), ("mtbf_s", SECONDS)),
    "failure_overhead_terms": (
        ("t_step_s", SECONDS), ("t_ckpt_s", SECONDS),
        ("interval_s", SECONDS), ("mtbf_s", SECONDS),
        ("downtime_s", SECONDS)),
    "goodput_fraction": (
        ("t_step_s", SECONDS), ("ckpt_overhead_s", SECONDS),
        ("rework_s", SECONDS), ("restart_s", SECONDS)),
}

# --- suffix conventions -------------------------------------------------------
# Longest match wins; matched against lowercased names.  A bare-name entry
# (no leading underscore) also matches the exact name.
SUFFIX_UNITS: Dict[str, object] = {
    "_flops": FLOPS,
    "flops": FLOPS,
    "_bytes": BYTES,
    "bytes": BYTES,
    "_bw": BYTES_PER_S,
    "_seconds": SECONDS,
    "_s": SECONDS,
    "_alpha": SECONDS,
    "alpha": SECONDS,
    "_steps": DIMENSIONLESS,
    "steps": DIMENSIONLESS,
    "_eff": DIMENSIONLESS,
    "_derate": DIMENSIONLESS,
    "derate": DIMENSIONLESS,
    # scale-shifted: same dimension, wrong scale — excluded, never inferred
    "_gb": EXCLUDED,
    "_gib": EXCLUDED,
    "_mb": EXCLUDED,
    "_ms": EXCLUDED,
    "_us": EXCLUDED,
    "_ns": EXCLUDED,
    "_hours": EXCLUDED,               # MTBF CLI surface: hours, not seconds
}


# --- exact-name declarations for local/parameter names ------------------------
# Wins over suffix conventions: ``peak_flops`` is a *rate* despite the
# ``_flops`` suffix (same for any future ``*_flops``-named ceiling).
NAME_UNITS: Dict[str, Unit] = {
    "peak_flops": FLOPS_PER_S,
    "peak": FLOPS_PER_S,
    "hbm_bw": BYTES_PER_S,
    "net_bw": BYTES_PER_S,
    "link_bw": BYTES_PER_S,
    "bw": BYTES_PER_S,
    "ckpt_bw": BYTES_PER_S,
    "goodput": DIMENSIONLESS,
}


def name_unit(name: str) -> object:
    """Declared unit for a local/param name: exact table, then suffix."""
    exact = NAME_UNITS.get(name)
    if exact is not None:
        return exact
    return suffix_unit(name)


def suffix_unit(name: str) -> object:
    """The declared unit for ``name`` by suffix convention, else None.

    Returns a :class:`Unit`, :data:`EXCLUDED`, or None (no convention).
    Longest suffix wins so ``step_ms`` hits ``_ms`` (excluded), not ``_s``.
    """
    low = name.lower()
    best: object = None
    best_len = -1
    for suf, unit in SUFFIX_UNITS.items():
        if (low.endswith(suf) or low == suf.lstrip("_")) and len(suf) > best_len:
            best, best_len = unit, len(suf)
    return best
