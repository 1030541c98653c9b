"""The port's Ridgeline core and measurement layer against ``repro``'s."""
import dataclasses
import math

import pytest
import torch

import numpy as np

from repro.core import hardware as jax_hw
from repro.core import ridgeline as jax_rl
from repro.distributed import collectives as jax_coll
from repro.measure import microbench as jax_mb
from repro.measure import timers as jax_timers
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.core import hardware, ridgeline
from repro_torch.distributed import collectives
from repro_torch.measure import microbench, timers

SPEC = dict(name="t", peak_flops=989e12, hbm_bw=3.35e12, net_bw=450e9,
            extra_links={"pod": 25e9}, alpha_compute=2e-6, alpha_memory=1e-6,
            alpha_network=5e-6, hbm_capacity_bytes=80e9)
WORKS = [("gemm", 1.4e11, 1e8, 0.0, 0.0), ("stream", 2e6, 1.2e7, 0.0, 0.0),
         ("allreduce", 1e6, 8e6, 6e6, 14.0), ("empty", 0.0, 0.0, 0.0, 0.0),
         ("net_only", 0.0, 0.0, 1e9, 3.0)]


def _analysis_fields(a):
    return (a.t_compute, a.t_memory, a.t_network, a.bottleneck.value,
            a.runtime, a.attained_flops, a.peak_fraction, a.x, a.y)


@pytest.mark.parametrize("alphas", [True, False])
@pytest.mark.parametrize("work", WORKS, ids=[w[0] for w in WORKS])
def test_analyze_equals_reference(work, alphas):
    spec = dict(SPEC) if alphas else {
        k: v for k, v in SPEC.items() if not k.startswith("alpha")}
    got = ridgeline.analyze(ridgeline.WorkUnit(*work),
                            hardware.HardwareSpec(**spec))
    want = jax_rl.analyze(jax_rl.WorkUnit(*work), jax_hw.HardwareSpec(**spec))
    assert _analysis_fields(got) == _analysis_fields(want)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("link", [None, "net", "pod"])
def test_resource_times_equal_reference_per_link(link):
    work = WORKS[2]
    got = ridgeline.resource_times(ridgeline.WorkUnit(*work),
                                   hardware.HardwareSpec(**SPEC), link)
    want = jax_rl.resource_times(jax_rl.WorkUnit(*work),
                                 jax_hw.HardwareSpec(**SPEC), link)
    assert got == want


@pytest.mark.parametrize("eff", [dict(f_half=2e8, p=0.7),
                                 dict(f_half=1e10, p=1.0, eff_min=0.05)])
@pytest.mark.parametrize("work", WORKS, ids=[w[0] for w in WORKS])
def test_resource_times_with_a_fitted_curve_equal_reference(work, eff):
    spec = dict(SPEC, link_alphas={"pod": 2e-5})
    got = ridgeline.analyze(
        ridgeline.WorkUnit(*work),
        hardware.HardwareSpec(**spec,
                              compute_eff=hardware.EfficiencyModel(**eff)))
    want = jax_rl.analyze(
        jax_rl.WorkUnit(*work),
        jax_hw.HardwareSpec(**spec, compute_eff=jax_hw.EfficiencyModel(**eff)))
    assert _analysis_fields(got) == _analysis_fields(want)
    for link in (None, "pod"):
        assert ridgeline.resource_times(
            ridgeline.WorkUnit(*work), hardware.HardwareSpec(**spec), link) \
            == jax_rl.resource_times(jax_rl.WorkUnit(*work),
                                     jax_hw.HardwareSpec(**spec), link)


def test_identity_curve_multiplies_by_exactly_one():
    work = ridgeline.WorkUnit(*WORKS[0])
    spec = hardware.HardwareSpec(**SPEC)
    assert spec.compute_eff.is_identity
    assert ridgeline.resource_times(work, spec)[0] == \
        SPEC["alpha_compute"] + work.flops / SPEC["peak_flops"]


@pytest.mark.parametrize("algorithm", ["ring", "bidir_ring", "tree"])
def test_all_reduce_costs_equal_reference(algorithm):
    payload = np.array([0.0, 1.0, 4096.0, 3.3e8])[:, None]
    n = np.array([1, 2, 3, 8, 64, math.inf])[None, :]
    got = collectives.all_reduce(payload, n, algorithm)
    want = jax_coll.all_reduce(payload, n, algorithm)
    assert np.array_equal(got.wire_bytes, want.wire_bytes)
    assert np.array_equal(got.steps, want.steps)
    assert np.array_equal(got.time(450e9, 5e-6), want.time(450e9, 5e-6))
    both = got + got.scaled(2)
    assert np.array_equal(both.wire_bytes, 3 * got.wire_bytes)
    assert collectives.canonical_algorithm("bidir") == "bidir_ring"
    with pytest.raises(ValueError, match="unknown all-reduce"):
        collectives.all_reduce(1.0, 2, "star")


def test_unknown_link_raises():
    with pytest.raises(KeyError, match="no network link"):
        hardware.H100_SXM.bandwidth_for("dci")


def test_h100_presets_are_the_datasheet():
    h = hardware.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.net_bw, h.hbm_capacity_bytes) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert hardware.H100_SXM_FP32.peak_flops == 67e12
    assert 295 < h.ridge_arithmetic < 296          # the bf16 ridge
    # the paper's question at W = 4096: batch 256 below the ridge, 1024 above
    for batch, bound in ((256, "memory"), (1024, "compute")):
        W = 4096
        work = ridgeline.WorkUnit("layer", 2.0 * batch * W * W,
                                  2.0 * (2 * batch * W + W * W), 0.0)
        assert ridgeline.analyze(work, h).bottleneck.value == bound


def test_negative_work_rejected():
    with pytest.raises(ValueError):
        ridgeline.WorkUnit("bad", -1.0, 0.0, 0.0)


@pytest.mark.parametrize("samples,warmup", [
    ((3.0, 1.0, 2.0, 5.0, 4.0), 0), ((9.0, 8.0, 1.0, 2.0, 3.0, 2.5), 2),
    ((7.0, 1.5), 1), ((0.25,) * 4, 0)])
def test_robust_stats_equal_reference(samples, warmup):
    got = timers.robust_stats(samples, warmup)
    want = jax_timers.robust_stats(samples, warmup)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.summary() == want.summary()
    if math.isnan(want.rel_spread):
        assert math.isnan(got.rel_spread)
    else:
        assert got.rel_spread == want.rel_spread


def test_robust_stats_rejects_bad_warmup():
    with pytest.raises(ValueError):
        timers.robust_stats((1.0,), warmup=1)
    with pytest.raises(ValueError):
        timers.robust_stats((1.0,), warmup=-1)


def test_time_callable_counts_samples_with_a_fake_clock():
    ticks = iter(range(100))
    calls = []
    stats = timers.time_callable(lambda: calls.append(1), device="cpu",
                                 repeats=3, warmup=2, calls_per_sample=2,
                                 clock=lambda: float(next(ticks)))
    assert len(calls) == 10
    assert len(stats.samples) == 3 and len(stats.warmup_samples) == 2
    assert stats.median == 0.5                   # one tick per 2 calls


def test_measurement_dict_keys_equal_reference():
    work = (("matmul_8x8x8", 1024.0, 768.0, 0.0),
            dict(seconds=1e-3, category="compute", best_seconds=9e-4,
                 rel_spread=math.nan, backend="cpu", meta=(("via", "ops"),)))
    got = microbench.Measurement(ridgeline.WorkUnit(*work[0]), **work[1])
    want = jax_mb.Measurement(jax_rl.WorkUnit(*work[0]), **work[1])
    assert got.to_dict() == want.to_dict()


def test_measurement_rejects_bad_category():
    with pytest.raises(ValueError):
        microbench.Measurement(ridgeline.WorkUnit("x", 1.0, 1.0, 0.0),
                               seconds=1.0, category="disk")


def test_benches_run_on_the_cpu_when_asked():
    ms = microbench.matmul_benches((16,), repeats=1, device="cpu")
    ms += microbench.memory_benches((), sizes_kb=(4,), repeats=1,
                                    device="cpu")
    assert [m.work.name for m in ms] == ["matmul_16x16x16", "saxpy_4kb"]
    assert ms[0].work.flops == 2.0 * 16 ** 3
    assert ms[0].work.mem_bytes == 3.0 * 16 * 16 * 4
    assert ms[1].work.mem_bytes == 3.0 * 1024 * 4
    assert all(m.backend == "cpu" and m.seconds > 0 for m in ms)
    assert dict(ms[0].meta) == {"via": "ops"}


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: microbench.matmul_benches((8,)),
                 lambda: microbench.memory_benches((1,)),
                 lambda: timers.time_callable(lambda: None),
                 lambda: timers.cuda_event_ms(lambda i: None),
                 lambda: timers.kernel_ms(lambda i: None),
                 lambda: mlp_params_from_numpy({"layers": [], "head": {}}),
                 lambda: microbench.default_suite(),
                 lambda: microbench.train_step_bench()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_train_step_bench_counts_its_step_on_the_cpu():
    m = microbench.train_step_bench(batch=8, width=16, layers=2, repeats=1,
                                    device="cpu")
    assert m.work.name == "train_step_mlp_b8_w16x2"
    assert m.category == "step" and m.backend == "cpu" and m.seconds > 0
    assert m.work.flops == 2.0 * 8 * 16 ** 2 * 5 + 6.0 * 8 * 16
    assert m.work.mem_bytes > 0 and m.work.net_bytes == 0.0
    assert dict(m.meta) == {"kind": "train_step", "arch": "dlrm-mlp"}


def _m(name, seconds, best):
    return microbench.Measurement(ridgeline.WorkUnit(name, 1.0, 1.0, 0.0),
                                  seconds=seconds, best_seconds=best,
                                  category="compute")


def _jm(m):
    return jax_mb.Measurement.from_dict(m.to_dict())


def test_merge_passes_equals_reference():
    passes = [[_m("a", 1.0, 0.9), _m("b", 2.0, 0.1)],
              [_m("a", 1.1, 0.8), _m("b", 2.1, 1.9)],
              [_m("a", 1.2, 1.0), _m("b", 2.2, 2.0)]]
    got = microbench.merge_passes(passes)
    want = jax_mb.merge_passes([[_jm(m) for m in p] for p in passes])
    assert [m.to_dict() for m in got] == [m.to_dict() for m in want]
    assert [m.best for m in got] == [0.8, 1.9]     # b's 0.1 is a fluke


def test_guarded_stats_retries_a_transient_failure_then_clamps():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("transient")
    stats = microbench._guarded_stats("x", flaky, torch.device("cpu"),
                                      repeats=3, warmup=1)
    assert len(stats.samples) == 3 and len(calls) == 1 + 1 + 4
    slow = microbench._guarded_stats(
        "y", lambda: __import__("time").sleep(0.01), torch.device("cpu"),
        repeats=50, warmup=2, timeout_s=0.1)
    assert 1 <= len(slow.samples) < 50
    with pytest.raises(ValueError):
        microbench._guarded_stats("z", lambda: int("x"), torch.device("cpu"),
                                  repeats=1, warmup=0)
