"""The port's Ridgeline plane against ``repro.core.ridgeline`` and
``repro.core.roofline``.

Both packages get the same work units (a seeded log-uniform grid, the exact
ridge points, units with a zero count and the empty unit) and specs built
from the same field values: the ``h100_sxm`` datasheet preset and a spec
with a ``pod`` link, α terms and a Hill efficiency curve.  Classifications,
analyses and the plotters' text must be equal, not close: the arithmetic is
the same code on Python floats.  The paper's theorem (the quadrant
construction equals the argmax of the times) is checked on the α-free
specs.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import hardware as jax_hw
from repro.core import ridgeline as jax_rl
from repro.core import roofline as jax_roof
from repro_torch.core import hardware, ridgeline, roofline

H100 = hardware.H100_SXM
LINKED = dataclasses.replace(
    H100, name="h100_pod", extra_links={"pod": 25e9}, alpha_compute=4e-6,
    alpha_memory=2e-6, alpha_network=8e-6, link_alphas={"pod": 2.5e-5},
    compute_eff=hardware.EfficiencyModel(f_half=2e9, p=0.9))
#: α-free twin of LINKED: a pod link but the paper's bandwidth-only times
PLANE = dataclasses.replace(LINKED, name="h100_pod_plane", alpha_compute=0.0,
                            alpha_memory=0.0, alpha_network=0.0,
                            link_alphas={},
                            compute_eff=hardware.EfficiencyModel())
SPECS = {"h100_sxm": H100, "h100_pod": LINKED, "h100_pod_plane": PLANE,
         "h100_sxm_fp32": hardware.H100_SXM_FP32}


def jax_spec(spec):
    """The reference's HardwareSpec with the port spec's field values."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(hardware.HardwareSpec)}
    fields["compute_eff"] = jax_hw.EfficiencyModel(**spec.compute_eff.to_dict())
    return jax_hw.HardwareSpec(**fields)


def _units(spec):
    """(name, F, B_M, B_N, steps) tuples: the grid, the ridges, the edges."""
    rng = np.random.default_rng(0)
    logs = rng.uniform([3, 0, 0], [16, 12, 12], size=(150, 3))
    out = [(f"g{i}", *(10.0 ** logs[i]), float(i % 4))
           for i in range(len(logs))]
    xs, ys, ks = spec.ridge_memory, spec.ridge_arithmetic, spec.ridge_network
    bn = 1e9
    out += [("ridge", ys * xs * bn, xs * bn, bn, 0.0),          # (x*, y*)
            ("x_ridge_low", 0.5 * ys * xs * bn, xs * bn, bn, 0.0),
            ("y_ridge_right", ys * 4 * xs * bn, 4 * xs * bn, bn, 0.0),
            ("hyperbola", ks * bn, 0.25 * xs * bn, bn, 0.0),     # x·y = k*
            ("no_net", 1e11, 1e9, 0.0, 0.0), ("no_mem", 1e12, 0.0, 1e9, 2.0),
            ("no_flops", 0.0, 1e9, 1e8, 0.0), ("empty", 0.0, 0.0, 0.0, 0.0)]
    return out


def _pair(u):
    name, f, bm, bn, steps = u
    return (ridgeline.WorkUnit(name, f, bm, bn, net_steps=steps),
            jax_rl.WorkUnit(name, f, bm, bn, net_steps=steps))


def _same_analysis(a, b):
    assert a.bottleneck.value == b.bottleneck.value
    assert (a.t_compute, a.t_memory, a.t_network, a.runtime, a.attained_flops,
            a.peak_fraction, a.x, a.y) == \
        (b.t_compute, b.t_memory, b.t_network, b.runtime, b.attained_flops,
         b.peak_fraction, b.x, b.y)
    assert a.summary() == b.summary()
    assert {r.value: t for r, t in a.resource_times().items()} == \
        {r.value: t for r, t in b.resource_times().items()}


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_classifiers_and_analyze_match_jax(spec_name):
    spec = SPECS[spec_name]
    jspec = jax_spec(spec)
    for u in _units(spec):
        w, jw = _pair(u)
        assert ridgeline.classify_by_quadrant(w, spec).value == \
            jax_rl.classify_by_quadrant(jw, jspec).value, u
        assert ridgeline.classify_by_times(w, spec).value == \
            jax_rl.classify_by_times(jw, jspec).value, u
        _same_analysis(ridgeline.analyze(w, spec), jax_rl.analyze(jw, jspec))
        x, y = w.memory_intensity, w.arithmetic_intensity
        if 0 < x < math.inf and 0 < y < math.inf:
            assert ridgeline.region_at(x, y, spec).value == \
                jax_rl.region_at(x, y, jspec).value


@pytest.mark.parametrize("spec_name", ["h100_sxm", "h100_pod_plane",
                                       "h100_sxm_fp32"])
def test_quadrant_equals_times_without_alpha(spec_name):
    """The paper's theorem, on every grid point, ridge point and tie."""
    spec = SPECS[spec_name]
    for u in _units(spec):
        w, _ = _pair(u)
        assert ridgeline.classify_by_quadrant(w, spec) == \
            ridgeline.classify_by_times(w, spec), u


def test_the_ridge_points_take_the_tie_order():
    units = {u[0]: _pair(u)[0] for u in _units(H100)}
    q = {n: ridgeline.classify_by_quadrant(w, H100).value
         for n, w in units.items()}
    assert q["ridge"] == q["hyperbola"] == q["y_ridge_right"] == "compute"
    assert q["x_ridge_low"] == q["no_net"] == "memory"
    assert q["empty"] == "compute" and q["no_mem"] == "network"


@pytest.mark.parametrize("spec_name", ["h100_pod", "h100_pod_plane"])
def test_analyze_multilink_matches_jax(spec_name):
    spec = SPECS[spec_name]
    jspec = jax_spec(spec)
    for net_b, net_s, pod_b, pod_s in ((4e8, 6.0, 1e8, 2.0), (1e6, 14.0, 0.0,
                                                               0.0),
                                       (0.0, 0.0, 5e9, 2.0)):
        links = {"net": (net_b, net_s), "pod": (pod_b, pod_s)}
        got = ridgeline.analyze_multilink(
            {k: ridgeline.WorkUnit("step", 3e12, 2e10, b, net_steps=s)
             for k, (b, s) in links.items()}, spec)
        want = jax_rl.analyze_multilink(
            {k: jax_rl.WorkUnit("step", 3e12, 2e10, b, net_steps=s)
             for k, (b, s) in links.items()}, jspec)
        _same_analysis(got, want)
    with pytest.raises(ValueError, match="at least one link"):
        ridgeline.analyze_multilink({}, spec)


NOTES = {"g6": "meas 12us vs model 9us (-25%)", "hyperbola": "measured",
         "no_net": "off the plane"}


@pytest.mark.parametrize("notes", [None, NOTES], ids=["plain", "notes"])
@pytest.mark.parametrize("spec_name", ["h100_sxm", "h100_pod"])
def test_plots_are_byte_identical(spec_name, notes):
    spec = SPECS[spec_name]
    jspec = jax_spec(spec)
    pairs = [_pair(u) for u in _units(spec)[::6] + _units(spec)[-8:]]
    got = [ridgeline.analyze(w, spec) for w, _ in pairs]
    want = [jax_rl.analyze(jw, jspec) for _, jw in pairs]
    assert ridgeline.ascii_plot(got, spec, point_notes=notes) == \
        jax_rl.ascii_plot(want, jspec, point_notes=notes)
    assert ridgeline.ascii_plot(got, spec, width=40, height=12,
                                x_range=(1e-3, 1e3), y_range=(1e-2, 1e4),
                                point_notes=notes) == \
        jax_rl.ascii_plot(want, jspec, width=40, height=12,
                          x_range=(1e-3, 1e3), y_range=(1e-2, 1e4),
                          point_notes=notes)
    svg = ridgeline.svg_plot(got, spec, width=880, height=560,
                             point_notes=notes)
    assert svg == jax_rl.svg_plot(want, jspec, width=880, height=560,
                                  point_notes=notes)
    assert svg.count('class="measured"') == sum(
        1 for a in got if (notes or {}).get(a.work.name) is not None
        and 0 < a.x < math.inf and 0 < a.y < math.inf)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_roofline_helpers_match_jax(spec_name):
    spec = SPECS[spec_name]
    jspec = jax_spec(spec)
    intensities = [0.0, 0.5, spec.ridge_arithmetic, spec.ridge_memory, 30.0,
                   1e4, math.inf]
    for i in intensities:
        assert roofline.attainable(i, spec) == jax_roof.attainable(i, jspec)
        assert roofline.classify(i, spec) == jax_roof.classify(i, jspec)
        assert roofline.memory_network_attainable(i, spec) == \
            jax_roof.memory_network_attainable(i, jspec)
        assert roofline.memory_network_classify(i, spec) == \
            jax_roof.memory_network_classify(i, jspec)
    assert roofline.sweep(intensities, spec) == \
        jax_roof.sweep(intensities, jspec)
    for f, b in ((2e9, 1e8), (1e6, 0.0), (0.0, 1e6)):
        assert dataclasses.asdict(roofline.point("p", f, b, spec)) == \
            dataclasses.asdict(jax_roof.point("p", f, b, jspec))
