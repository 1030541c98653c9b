"""Failure-aware planning and fault-injection, as ``repro.resilience``.

Layers, mirroring the model↔measurement discipline everywhere else:

* :mod:`repro_torch.resilience.failures` — the analytic side: mesh MTBF,
  checkpoint cost, Young/Daly cadence, and the amortized per-step goodput
  overheads the reference's ``plan_grid --goodput`` folds into the
  ranking.  NumPy-only.
* :mod:`repro_torch.resilience.faults` — deterministic seeded fault plans
  (preemptions, link flaps, stragglers, checkpoint corruption).
* :mod:`repro_torch.resilience.harness` — replays a fault plan through the
  resilient training runner and measures the goodput actually delivered,
  to be compared against the analytic prediction.
* :mod:`repro_torch.resilience.degraded` — re-plan on the surviving chips
  (``launch.plan_grid``), restore the checkpoint onto the new mesh
  (``checkpoint.elastic``), remap the data schedule.

Importing the package pulls only the numpy-backed layers (analytic
kernels + fault plans); the torch-backed harness and degraded restart stay
behind their own module imports.
"""
from repro_torch.resilience.failures import (  # noqa: F401
    FailureModel,
    ckpt_time_s,
    failure_overhead_terms,
    goodput_fraction,
    goodput_terms,
    mesh_mtbf_s,
    young_daly_interval_s,
)
from repro_torch.resilience.faults import (  # noqa: F401
    FaultEvent,
    FaultPlan,
)

__all__ = [
    "FailureModel",
    "FaultEvent",
    "FaultPlan",
    "ckpt_time_s",
    "failure_overhead_terms",
    "goodput_fraction",
    "goodput_terms",
    "mesh_mtbf_s",
    "young_daly_interval_s",
]
