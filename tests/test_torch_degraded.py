"""The port's degraded restart (``repro_torch.resilience.degraded``) against
``repro.resilience.degraded``: the cases of ``tests/test_resilience.py``'s
``TestDegradedRestart``.

The re-plan is held to the reference's on a spec built at test time from
the reference's ``TPU_V5E`` fields (never a port preset) and run on the
port's ``h100_sxm``; the restart restores onto a one-device CPU mesh (the
mesh the plan gives one survivor), whose process group each case takes down
again.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_reduced as jax_get_reduced
from repro.core import hardware as jax_hw
from repro.resilience import degraded as jax_degraded
from repro.resilience.failures import FailureModel as JaxFailureModel
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.core import hardware
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizer import AdamW
from repro_torch.resilience import degraded
from repro_torch.resilience.failures import FailureModel
from repro_torch.resilience.harness import _corrupt_latest
from repro_torch.train.loop import init_train_state, model_param_specs
from repro_torch.tree import tree_leaves


def _v5e():
    spec = jax_hw.TPU_V5E
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    fields["compute_eff"] = hardware.EfficiencyModel(
        **spec.compute_eff.to_dict())
    return hardware.HardwareSpec(**fields)


@pytest.fixture
def no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mtbf", [None, 100.0, 10.0])
@pytest.mark.parametrize("chips", [16, 8, 4])
def test_replan_on_survivors_equals_the_reference(chips, mtbf):
    cfg, jcfg = get_reduced("dlrm-mlp"), jax_get_reduced("dlrm-mlp")
    kw = dict(max_pp=2)
    got = degraded.replan_on_survivors(
        cfg, _v5e(), chips, 4096,
        failure=None if mtbf is None else FailureModel.from_mtbf_hours(mtbf),
        **kw)
    want = jax_degraded.replan_on_survivors(
        jcfg, jax_hw.TPU_V5E, chips, 4096,
        failure=None if mtbf is None else JaxFailureModel.from_mtbf_hours(
            mtbf), **kw)
    assert (got.dp, got.tp, got.pp, got.microbatches) == \
        (want.dp, want.tp, want.pp, want.microbatches)
    assert got.runtime == pytest.approx(want.runtime, rel=1e-12)
    assert got.goodput == pytest.approx(want.goodput, rel=1e-12)


def test_replan_on_survivors_failure_aware():
    cfg = get_reduced("dlrm-mlp")
    plan = degraded.replan_on_survivors(
        cfg, "h100_sxm", 16, 4096, max_pp=2,
        failure=FailureModel.from_mtbf_hours(100.0))
    assert plan.chips == 16
    assert 0.0 < plan.goodput < 1.0          # failures actually priced
    healthy = degraded.replan_on_survivors(cfg, "h100_sxm", 16, 4096,
                                           max_pp=2)
    assert healthy.goodput == 1.0


def test_no_survivors_raises():
    with pytest.raises(ValueError, match="no survivors"):
        degraded.replan_on_survivors(get_reduced("dlrm-mlp"), "h100_sxm", 0,
                                     64)


def _state(cfg):
    return init_train_state(torch.Generator().manual_seed(4), cfg,
                            AdamW(learning_rate=1e-3), device="cpu")


def test_restart_restores_onto_surviving_mesh(tmp_path, no_group):
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    state = _state(cfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(40, state.params)
    out = degraded.degraded_restart(
        ck, state.params, model_param_specs(cfg), cfg, "h100_sxm",
        surviving_chips=1, global_batch=64,
        failure=FailureModel.from_mtbf_hours(50.0),
        data_cfg=DataConfig(global_batch=64), surviving_hosts=1,
        device="cpu")
    assert out.step == 40
    assert (out.plan.dp, out.plan.tp, out.plan.chips) == (1, 1, 1)
    assert out.mesh.size() == 1 and out.mesh.mesh_dim_names == ("data",
                                                                "model")
    assert [c.host_id for c in out.data_configs] == [0]
    for a, b in zip(tree_leaves(state.params), tree_leaves(out.state)):
        assert type(b) is torch.Tensor and torch.equal(a, b)


def test_restart_skips_corrupt_latest(tmp_path, no_group):
    """A degraded restart never resumes from bytes that fail their
    checksum: the corrupt latest step quarantines, restore falls back."""
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    state = _state(cfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(10, state.params)
    ck.save(20, state.params)
    assert _corrupt_latest(ck)
    out = degraded.degraded_restart(
        ck, state.params, model_param_specs(cfg), cfg, "h100_sxm",
        surviving_chips=1, global_batch=64, device="cpu")
    assert out.step == 10
    assert any(".quarantined_" in p.name for p in tmp_path.iterdir())
    for a, b in zip(tree_leaves(state.params), tree_leaves(out.state)):
        assert torch.equal(a, b)


def test_more_survivors_than_the_world_raise(tmp_path, no_group):
    """Four survivors plan a mesh of four; one process is a world of one, and
    the mesh is never shrunk to fit it."""
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    state = _state(cfg)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state.params)
    with pytest.raises(ValueError, match="needs 4"):
        degraded.degraded_restart(ck, state.params, model_param_specs(cfg),
                                  cfg, "h100_sxm", surviving_chips=4,
                                  global_batch=64, device="cpu")
