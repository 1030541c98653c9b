"""Elastic scaling: reshard a checkpoint onto a different mesh, as
``repro.checkpoint.elastic``.

Scenario: a 16x16 pod loses a row and the job must restart on 12x16, or
scales from 1 to 2 pods.  Because checkpoints store *full logical* arrays
(``checkpointer.py``), resharding is metadata: build the new mesh, derive
shardings from the same logical-axis specs under the new axis sizes
(divisibility fallbacks recomputed), and lay each restored leaf out on them
(``distributed.sharding.place``: every rank keeps its slice of the array it
read; a mesh of one device keeps the tensor local).

Also batch-schedule remapping: with the same global batch and a different
host count, each surviving host's shard of the batch changes;
``data.pipeline`` batches are pure functions of (seed, step, host_id), so
the remap is constructing new ``DataConfig``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.sharding import (NamedSharding, _drop_nondividing,
                                              logical_spec, map_specs,
                                              use_sharding)


def reshard_specs(specs: Any, like: Any, mesh, rules=None) -> Any:
    """Logical specs + target mesh -> ``NamedSharding`` tree
    (divisibility-safe); a leaf of ``like`` that is no tensor (the train
    state's generator) gets None."""

    def one(axes, proto):
        if not isinstance(proto, torch.Tensor):
            return None
        spec = _drop_nondividing(logical_spec(axes, rules),
                                 tuple(proto.shape), mesh)
        return NamedSharding(mesh, spec)

    return map_specs(one, specs, like)


def restore_on_mesh(checkpointer, like: Any, specs: Any, mesh,
                    rules=None, step: Optional[int] = None
                    ) -> Tuple[Any, int]:
    """Restore a checkpoint saved on any topology onto ``mesh``."""
    with use_sharding(mesh, rules):
        shardings = reshard_specs(specs, like, mesh, rules=None)
        return checkpointer.restore(like, step=step, shardings=shardings)


def remap_data_configs(old: DataConfig, new_n_hosts: int) -> List[DataConfig]:
    """Recompute per-host data configs after an elastic resize."""
    if old.global_batch % new_n_hosts:
        raise ValueError(
            f"global batch {old.global_batch} must divide new host count "
            f"{new_n_hosts}")
    return [dataclasses.replace(old, n_hosts=new_n_hosts, host_id=h)
            for h in range(new_n_hosts)]
