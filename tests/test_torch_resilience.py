"""The port's resilience layers against ``repro.resilience`` and
``repro.train.fault_tolerance``: fault plans and the analytic kernels equal
the reference's, the runner's retry, give-up and backoff follow it, and the
seed-6 acceptance replay (``tests/test_resilience.py``) gives the reference's
exact counters through the port's runner, checkpoint files and train steps.
"""
import os

import numpy as np
import pytest
import torch

from repro.resilience import failures as jax_failures
from repro.resilience import faults as jax_faults
from repro.train import fault_tolerance as jax_ft
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, make_stream, to_device
from repro_torch.obs.metrics import REGISTRY
from repro_torch.optim.optimizer import AdamW
from repro_torch.resilience import failures, faults
from repro_torch.resilience.faults import (CORRUPT_CKPT, LINK_FLAP,
                                           PREEMPTION, STRAGGLER, FaultPlan)
from repro_torch.resilience.harness import (VirtualCosts, predicted_goodput,
                                            replay)
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.loop import (TrainStepConfig, build_train_step,
                                    init_train_state)


def _events(plan):
    return [(e.step, e.kind, e.slowdown) for e in plan.events]


# --- fault plans and the analytic kernels -------------------------------------

@pytest.mark.parametrize("seed, n_steps, kw", [
    (6, 200, {}), (17, 300, {}), (0, 200, dict(straggler_slowdown=5.0)),
    (3, 100, dict(n_preemptions=10, n_stragglers=10, min_step=5))])
def test_fault_plan_equals_the_reference(seed, n_steps, kw):
    got = FaultPlan.generate(seed, n_steps, **kw)
    want = jax_faults.FaultPlan.generate(seed, n_steps, **kw)
    assert _events(got) == _events(want)
    assert got.n_restart_faults == want.n_restart_faults
    for kind in faults.KINDS:
        assert got.count(kind) == want.count(kind)
    assert sorted(got.by_step()) == sorted(want.by_step())


def test_fault_plan_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="do not fit"):
        FaultPlan.generate(0, 5, n_preemptions=10)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultEvent(step=1, kind="meteor")


MTBF = np.array([3600.0, np.inf, 1e5])
CHIPS = np.array([1.0, 64.0, 1024.0])


def test_failure_kernels_equal_the_reference():
    m, jm = (failures.FailureModel.from_mtbf_hours(1000.0, restart_s=45.0),
             jax_failures.FailureModel.from_mtbf_hours(1000.0, restart_s=45.0))
    assert m.downtime_s == jm.downtime_s and m.mtbf_chip_s == jm.mtbf_chip_s
    pairs = [
        (failures.mesh_mtbf_s(CHIPS, m.mtbf_chip_s),
         jax_failures.mesh_mtbf_s(CHIPS, jm.mtbf_chip_s)),
        (failures.ckpt_time_s(CHIPS * 1e9, 2e9),
         jax_failures.ckpt_time_s(CHIPS * 1e9, 2e9)),
        (failures.young_daly_interval_s(np.array([8.0] * 3), MTBF),
         jax_failures.young_daly_interval_s(np.array([8.0] * 3), MTBF)),
        (failures.goodput_fraction(np.ones(3), CHIPS / 8, np.ones(3),
                                   np.zeros(3)),
         jax_failures.goodput_fraction(np.ones(3), CHIPS / 8, np.ones(3),
                                       np.zeros(3))),
    ]
    args = (np.ones(3), np.array([5.0] * 3), np.array([100.0, 0.0, 50.0]),
            MTBF, 60.0)
    pairs += list(zip(failures.failure_overhead_terms(*args),
                      jax_failures.failure_overhead_terms(*args)))
    kw = dict(ckpt_bw=1e9)
    pairs += list(zip(
        failures.goodput_terms(np.ones(3), CHIPS * 1e8, CHIPS, model=m, **kw),
        jax_failures.goodput_terms(np.ones(3), CHIPS * 1e8, CHIPS, model=jm,
                                   **kw)))
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="ckpt_bw"):
        failures.ckpt_time_s(1.0, 0.0)


# --- the runner ---------------------------------------------------------------

class _Stream:
    def batch(self, step):
        return {"x": np.float32(step)}


def _step(state, batch):
    new = state + 1.0
    return new, {"loss": new.sum(), "ce": new.sum()}


def _runner(tmp_path, hook, **cfg):
    return ft.ResilientRunner(
        _step, Checkpointer(str(tmp_path), keep=2),
        ft.RunnerConfig(ckpt_every=2, async_ckpt=False, **cfg),
        failure_hook=hook)


def test_retry_restores_the_checkpoint_and_replays(tmp_path):
    fired = set()

    def hook(step):
        if step == 5 and step not in fired:
            fired.add(step)
            raise ft.SimulatedFailure("preempted")

    state, history = _runner(tmp_path, hook, backoff_base_s=0.0).run(
        torch.zeros(3), _Stream(), n_steps=8)
    # steps 0-4 ran, 5 failed, the restore of step 4 replayed 4..7
    assert [h["step"] for h in history] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert torch.equal(state, torch.full((3,), 8.0))
    assert Checkpointer(str(tmp_path)).latest_step() == 8


def test_a_persistent_fault_gives_up_after_max_retries(tmp_path, monkeypatch):
    waits, calls = [], []
    monkeypatch.setattr(ft.time, "sleep", waits.append)

    def hook(step):
        if step == 3:
            calls.append(step)
            raise ft.SimulatedFailure("every time")

    cfg = dict(max_retries=3, backoff_base_s=0.5, backoff_max_s=1.5,
               backoff_jitter=0.1)
    with pytest.raises(ft.SimulatedFailure):
        _runner(tmp_path, hook, **cfg).run(torch.zeros(2), _Stream(),
                                           n_steps=6)
    assert len(calls) == 4                   # the first try + 3 retries
    # the reference's seeded backoff: the same waits, base 2^(k-1) capped
    ref = jax_ft.ResilientRunner(None, None, jax_ft.RunnerConfig(**cfg))
    assert waits == [ref._backoff(k) for k in (1, 2, 3)]
    assert waits[2] == pytest.approx(1.5, rel=0.1) != waits[1]


def test_runner_records_its_span_counter_and_histogram(tmp_path):
    from repro_torch.obs import trace
    hist = REGISTRY.histogram("train.step_seconds")
    before = hist.count
    tracer = trace.enable()
    try:
        fired = set()

        def hook(step):
            if step == 1 and step not in fired:
                fired.add(step)
                raise ft.SimulatedFailure("once")

        _runner(tmp_path, hook, backoff_base_s=0.0).run(
            torch.zeros(1), _Stream(), n_steps=4)
    finally:
        trace.disable()
    assert tracer.counters()["train.recoverable_failures"] == 1
    spans = [e for e in tracer.to_dict()["traceEvents"]
             if e.get("name") == "train.run"]
    assert len(spans) == 1 and spans[0]["args"]["steps_run"] == 5
    assert hist.count - before == 5


# --- the acceptance replay ----------------------------------------------------

SEED, N_STEPS, CKPT_EVERY = 6, 200, 10


@pytest.fixture(scope="module")
def replay_result(tmp_path_factory):
    """Built as ``tests/test_resilience.py`` builds it: reduced dlrm-mlp in
    fp32, AdamW 1e-3, the stream of seed 11 at batch 8."""
    cfg = get_reduced("dlrm-mlp").replace(compute_dtype=torch.float32)
    opt = AdamW(learning_rate=1e-3)
    step = build_train_step(cfg, opt, TrainStepConfig())
    stream = make_stream(cfg, DataConfig(seed=11, global_batch=8))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                             device="cpu")
    plan = FaultPlan.generate(SEED, N_STEPS)
    d = str(tmp_path_factory.mktemp("replay_ckpt"))
    # The runner flags a step slower than 3x the EWMA of step times. With
    # torch's default intra-op threads, several processes on a loaded host
    # oversubscribe the cores and push that EWMA past the straggler's sleep,
    # so the replay runs at one thread; the count is process-wide and is put
    # back for the tests that run after this one.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = replay(lambda s, b: step(s, to_device(b, "cpu")), state,
                     stream, plan, d, ckpt_every=CKPT_EVERY,
                     straggler_sleep_s=0.02, keep_history=True)
    finally:
        torch.set_num_threads(threads)
    return plan, res, d


def test_replay_counters_are_the_reference_s(replay_result):
    plan, res, root = replay_result
    assert plan.count(PREEMPTION) == 3 and plan.count(LINK_FLAP) == 1
    assert plan.count(STRAGGLER) == 2 and plan.count(CORRUPT_CKPT) == 1
    assert res.executed_steps == 233
    assert res.saves == 22
    assert res.goodput_measured == pytest.approx(0.7181328, abs=1e-6)
    assert res.restarts == plan.n_restart_faults == 4
    assert res.quarantined == 1
    assert any(".quarantined_" in n for n in os.listdir(root))
    assert res.stragglers_flagged >= 1
    assert int(res.final_state.step) == N_STEPS


def test_replay_loses_no_committed_progress(replay_result):
    _, res, _ = replay_result
    steps_run = [h["step"] for h in res.history]
    assert set(steps_run) == set(range(N_STEPS))
    assert steps_run[-1] == N_STEPS - 1
    assert res.replayed_steps == 33
    assert all(np.isfinite(h["loss"]) for h in res.history)


def test_replay_goodput_against_the_analytic_twin(replay_result):
    plan, res, _ = replay_result
    analytic = res.goodput_analytic(CKPT_EVERY, plan.n_restart_faults)
    assert analytic == pytest.approx(
        predicted_goodput(plan, ckpt_every=CKPT_EVERY))
    assert 0.0 < res.goodput_measured <= analytic
    assert abs(res.goodput_measured - analytic) < 0.05
    c = res.costs
    assert c == VirtualCosts()
    assert res.wall_s == pytest.approx(
        res.executed_steps * c.t_step_s + res.saves * c.t_ckpt_s
        + res.restarts * c.downtime_s)
