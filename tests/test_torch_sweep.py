"""The port's vectorized sweep against ``repro.core.sweep``.

Both packages sweep the same broadcast grids (made with numpy from a seed):
work units against the ``h100_sxm`` spec, hardware swept as a grid axis,
α terms with serialized hops, and a Hill ``compute_eff``.  Times are held
within rtol 1e-12 (the same numpy arithmetic), labels, region counts and
the crossings exactly.  The port's sweep also agrees elementwise with its
own scalar ``analyze`` and resolves a calibrated name through its own
registry.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import hardware as jax_hw
from repro.core import sweep as jax_sweep
from repro.core.ridgeline import Resource as JaxResource
from repro_torch.core import hardware, sweep
from repro_torch.core.ridgeline import Resource, WorkUnit, analyze
from repro_torch.measure import calibrate, microbench

RTOL = 1e-12
H100 = hardware.H100_SXM
HILL = {"f_half": 2e9, "p": 0.9, "eff_min": 0.02}


def jax_spec(spec):
    """The reference's HardwareSpec with the port spec's field values."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(hardware.HardwareSpec)}
    fields["compute_eff"] = jax_hw.EfficiencyModel(**spec.compute_eff.to_dict())
    return jax_hw.HardwareSpec(**fields)


def _terms(seed):
    """(F (n,1,1), B_M (1,m,1), B_N (1,1,k)) log-uniform, with zeros."""
    rng = np.random.default_rng(seed)
    f = 10.0 ** rng.uniform(3, 16, size=(12, 1, 1))
    bm = 10.0 ** rng.uniform(0, 12, size=(1, 9, 1))
    bn = 10.0 ** rng.uniform(0, 12, size=(1, 1, 7))
    f[0], bm[0, 0], bn[0, 0, 0] = 0.0, 0.0, 0.0
    return f, bm, bn


def _cases(seed):
    """name -> (args, port kwargs, reference kwargs)."""
    f, bm, bn = _terms(seed)
    rng = np.random.default_rng(seed + 100)
    peaks = np.array([67e12, 989e12, 1979e12]).reshape(1, 1, 1, 3)
    hbms = np.array([2.0e12, 3.35e12, 3.35e12]).reshape(1, 1, 1, 3)
    nets = np.array([25e9, 450e9, 900e9]).reshape(1, 1, 1, 3)
    steps = rng.integers(0, 16, size=(1, 1, 7)).astype(np.float64)
    alphas = dict(alpha_compute=np.array([0.0, 4e-6]).reshape(2, 1, 1, 1),
                  alpha_memory=2e-6, alpha_network=8e-6)
    hill, jhill = hardware.EfficiencyModel(**HILL), \
        jax_hw.EfficiencyModel(**HILL)
    hw_eff = dataclasses.replace(H100, name="h100_hill", compute_eff=hill)
    return {
        "spec": ((f, bm, bn), {"hw": H100}, {"hw": jax_spec(H100)}),
        "hardware_axis": ((f[..., None], bm[..., None], bn[..., None]),
                          dict(peak_flops=peaks, hbm_bw=hbms, net_bw=nets),
                          dict(peak_flops=peaks, hbm_bw=hbms, net_bw=nets)),
        "alpha": ((f, bm, bn), dict(hw=H100, net_steps=steps, **alphas),
                  dict(hw=jax_spec(H100), net_steps=steps, **alphas)),
        "hill_kwarg": ((f, bm, bn), dict(hw=H100, compute_eff=hill),
                       dict(hw=jax_spec(H100), compute_eff=jhill)),
        "hill_spec": ((f, bm, bn), dict(hw=hw_eff),
                      dict(hw=jax_spec(hw_eff))),
    }


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", ["spec", "hardware_axis", "alpha",
                                  "hill_kwarg", "hill_spec"])
def test_sweep_matches_jax(case, seed):
    args, kw, jkw = _cases(seed)[case]
    got = sweep.sweep(*args, **kw)
    want = jax_sweep.sweep(*args, **jkw)
    assert got.shape == want.shape
    for field in ("t_compute", "t_memory", "t_network", "runtime",
                  "attained_flops", "peak_fraction", "x", "y"):
        _close(getattr(got, field), getattr(want, field))
    assert np.array_equal(got.labels(), want.labels())
    assert got.region_counts() == want.region_counts()
    assert [r.value for r in got.resources().ravel()] == \
        [r.value for r in want.resources().ravel()]


def test_sweep_agrees_with_the_scalar_model():
    f, bm, bn = (x.ravel() for x in np.broadcast_arrays(*_terms(3)))
    hw = dataclasses.replace(H100, name="h100_hill", alpha_memory=2e-6,
                             compute_eff=hardware.EfficiencyModel(**HILL))
    res = sweep.sweep(f, bm, bn, hw)
    for i in range(len(f)):
        a = analyze(WorkUnit("w", f[i], bm[i], bn[i]), hw)
        assert res.labels()[i] == a.bottleneck.value
        assert math.isclose(res.runtime[i], a.runtime, rel_tol=RTOL)


def test_eff_grid_matches_jax():
    q = np.array([0.0, 1.0, 1e6, 2e9, 1e15])
    for kw in ({}, HILL, {"f_half": 1e9, "p": 1.0}):
        got = sweep.eff_grid(hardware.EfficiencyModel(**kw), q)
        want = jax_sweep.eff_grid(jax_hw.EfficiencyModel(**kw), q)
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert sweep.eff_grid(None, q) == 1.0


def test_crossings_and_transitions_match_jax():
    """A 1-D batch sweep of the paper's data-parallel MLP step: compute time
    grows with the batch, the all-reduce stays, so the bottleneck hands over
    from the network to compute (Fig. 6 on the H100)."""
    batches = np.array([4, 16, 64, 256, 1024, 4096, 16384], dtype=np.float64)
    flops = 6.0 * batches * 4096 ** 2 * 8
    mem, net = 8 * 4096 ** 2 * 4.0, 2 * 8 * 4096 ** 2 * 4.0
    got = sweep.sweep(flops, mem, net, H100)
    want = jax_sweep.sweep(flops, mem, net, jax_spec(H100))
    assert sweep.transitions(got, batches) == \
        jax_sweep.transitions(want, batches)
    assert sweep.transitions(got) == [(5, "network", "compute")]
    for log_x in (True, False):
        assert sweep.ridge_crossing(got, batches, log_x=log_x) == \
            jax_sweep.ridge_crossing(want, batches, log_x=log_x)
        assert sweep.ridge_crossing(
            got, batches, Resource.MEMORY, Resource.COMPUTE, log_x=log_x) == \
            jax_sweep.ridge_crossing(want, batches, JaxResource.MEMORY,
                                     JaxResource.COMPUTE, log_x=log_x)
    xs = np.array([0.0, 1.0, 2.0, 3.0])
    for ta, tb in (([0.0, 1.0, 2.0, 3.0], [1.5] * 4),
                   ([1.0, 1.0, 1.0, 1.0], [0.0, 1.0, 2.0, 2.0]),
                   ([1.0] * 4, [2.0] * 4)):
        assert sweep.crossover(xs, ta, tb, log_x=True) == \
            jax_sweep.crossover(xs, ta, tb, log_x=True)
    assert sweep.grid(batch=[1, 2, 4], dp=[1, 2])["dp"].shape == (3, 2)
    with pytest.raises(ValueError, match="1-D"):
        sweep.transitions(sweep.sweep(np.ones((2, 2)), 1.0, 1.0, H100))
    with pytest.raises(ValueError, match="length"):
        sweep.transitions(got, batches[:3])


def test_bad_broadcast_raises():
    with pytest.raises(ValueError):
        sweep.sweep(np.ones(3), np.ones(4), 1.0, H100)
    with pytest.raises(ValueError):
        sweep.sweep(np.ones((2, 3)), 1.0, 1.0, peak_flops=np.ones(2),
                    hbm_bw=1.0, net_bw=1.0)
    with pytest.raises(ValueError, match="pass hw="):
        sweep.sweep(1.0, 1.0, 1.0)


def test_a_calibrated_name_resolves_through_the_ports_registry(
        tmp_path, monkeypatch):
    recs = [{"name": f"matmul_{s}", "flops": 2.0 * s ** 3,
             "mem_bytes": 12.0 * s * s, "net_bytes": 0.0, "net_steps": 0.0,
             "seconds": 5e-6 + 2.0 * s ** 3 / 4e13, "category": "compute",
             "meta": {}} for s in (64, 256, 1024, 2048)]
    recs += [{"name": f"saxpy_{mb}", "flops": mb * 2 ** 19,
              "mem_bytes": mb * 3.0 * 2 ** 20, "net_bytes": 0.0,
              "seconds": 2e-6 + mb * 3.0 * 2 ** 20 / 3e12,
              "category": "memory", "meta": {}} for mb in (1, 32, 64)]
    calib = calibrate.fit_ceilings(
        [microbench.Measurement.from_dict(r) for r in recs],
        hardware.H100_SXM_FP32)
    calib.save(str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION_DIR", str(tmp_path))
    f, bm, bn = _terms(0)
    got = sweep.sweep(f, bm, bn, "h100_sxm_fp32_cal")
    want = sweep.sweep(f, bm, bn, calib.spec())
    assert np.array_equal(got.runtime, want.runtime)
    assert got.peak_fraction.max() <= 1.0
