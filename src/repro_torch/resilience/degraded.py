"""Degraded restart: lose chips, re-plan on the survivors, restore, go.

The port of ``repro.resilience.degraded``, the glue a fleet controller
calls after a hardware loss shrinks the pod:

1. ``replan_on_survivors`` re-runs the grid planner
   (``launch.plan_grid.plan_grid``) at the surviving chip count (same model,
   same global batch) and returns the best mesh.  With a
   :class:`FailureModel` the ranking is failure-aware: the smaller fleet has
   a *longer* mesh MTBF, so the winner can differ from a healthy re-rank.
2. ``degraded_restart`` builds the surviving mesh from that plan
   (``launch.mesh.make_mesh``: the mesh must be the world, so on one card
   the plan must be dp1 x tp1), restores the latest verified checkpoint onto
   it (corrupt steps quarantine and fall back, per
   ``checkpoint.checkpointer``), and remaps the data schedule for the
   surviving hosts.

Restart cost is what ``FailureModel.reshard_s`` prices in the planner's
goodput terms; this module is that constant made concrete.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

from repro_torch.checkpoint.elastic import remap_data_configs, restore_on_mesh
from repro_torch.core.hardware import HardwareSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import DeviceLike
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.plan_grid import MeshPlan, plan_grid
from repro_torch.models.config import ModelConfig
from repro_torch.resilience.failures import FailureModel


def replan_on_survivors(cfg: ModelConfig, hw: Union[HardwareSpec, str],
                        surviving_chips: int, global_batch: int, *,
                        seq: int = 1, max_pp: int = 1, max_ep: int = 1,
                        failure: Optional[FailureModel] = None,
                        **plan_kw) -> MeshPlan:
    """Best mesh for the surviving fleet (failure-aware when ``failure``
    is given: goodput terms are folded into the ranking)."""
    if surviving_chips < 1:
        raise ValueError(f"no survivors: {surviving_chips} chips")
    grid = plan_grid(cfg, hw, [surviving_chips], [global_batch], seq=seq,
                     max_pp=max_pp, max_ep=max_ep,
                     goodput=failure is not None, failure=failure,
                     **plan_kw)
    return grid.best(surviving_chips, global_batch)


@dataclasses.dataclass
class DegradedRestart:
    """Everything the controller needs to resume on the shrunken fleet."""

    plan: MeshPlan               # re-ranked mesh for the survivors
    mesh: Any                    # the (data, model) DeviceMesh
    state: Any                   # checkpoint restored + laid out on it
    step: int                    # step the restore landed on
    data_configs: Optional[List[DataConfig]] = None


def degraded_restart(checkpointer, like: Any, specs: Any, cfg: ModelConfig,
                     hw: Union[HardwareSpec, str], surviving_chips: int,
                     global_batch: int, *, seq: int = 1,
                     failure: Optional[FailureModel] = None,
                     data_cfg: Optional[DataConfig] = None,
                     surviving_hosts: int = 1, rules=None,
                     step: Optional[int] = None, device: DeviceLike = None,
                     **plan_kw) -> DegradedRestart:
    """Re-plan on ``surviving_chips``, restore the checkpoint onto the new
    mesh (on ``device``: None is the card), and remap the data schedule.

    The restore inherits every integrity guarantee of the checkpointer: a
    corrupted latest step is quarantined and the restore falls back to the
    previous committed one, so a degraded restart never resumes from bytes
    that fail their checksum.
    """
    plan = replan_on_survivors(cfg, hw, surviving_chips, global_batch,
                               seq=seq, failure=failure, **plan_kw)
    # the runtime mesh materializes the (dp, tp) axes; pp/ep stay logical
    # (stage/expert placement), matching launch/mesh conventions
    mesh = make_mesh((plan.dp, plan.tp), ("data", "model"), device=device)
    state, got_step = restore_on_mesh(checkpointer, like, specs, mesh,
                                      rules=rules, step=step)
    data = (remap_data_configs(data_cfg, surviving_hosts)
            if data_cfg is not None else None)
    return DegradedRestart(plan=plan, mesh=mesh, state=state, step=got_step,
                           data_configs=data)
