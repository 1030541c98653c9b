"""The port's Ridgeline core and measurement layer against ``repro``'s."""
import dataclasses
import math

import pytest
import torch

from repro.core import hardware as jax_hw
from repro.core import ridgeline as jax_rl
from repro.measure import microbench as jax_mb
from repro.measure import timers as jax_timers
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.core import hardware, ridgeline
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
                 lambda: mlp_params_from_numpy({"layers": [], "head": {}})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
