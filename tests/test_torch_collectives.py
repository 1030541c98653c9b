"""The port's collective cost models against ``repro.distributed.collectives``.

Every function is the reference's numpy copied unchanged, so every case holds
the two to exact equality: wire bytes, hop counts, the selected algorithm,
the flip payload.  The cases are numpy grids (payloads over ten decades, group
sizes from 1 to 4096 and inf, per-element links) and a few Hypothesis draws,
plus the neighbourhood n = 9, bw = 1e8, α ≈ 1e-3 of the reference's
intermittent flip-point property test: at n = 9 the tree's 2·⌈log2 9⌉ = 8 hops
tie the bidirectional ring's n − 1 = 8, so neither function finds a flip.
"""
import math

import numpy as np
import pytest

from repro.distributed import collectives as jax_coll
from repro_torch.distributed import collectives as coll
from tests._hypothesis_compat import given, settings, st

PAYLOAD = np.logspace(0, 10, 11)[:, None]                    # (11, 1)
GROUP = np.array([1, 2, 3, 7, 8, 9, 16, 17, 255, 4096, math.inf])[None, :]


def _same(got, want):
    """Exact equality of two CollectiveCosts, arrays or scalars."""
    if isinstance(want, jax_coll.CollectiveCost):
        assert isinstance(got, coll.CollectiveCost)
        _same(got.wire_bytes, want.wire_bytes)
        _same(got.steps, want.steps)
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("algo", ["ring", "bidir_ring", "tree"])
def test_all_reduce_and_bytes_equal(algo):
    _same(coll.all_reduce(PAYLOAD, GROUP, algo),
          jax_coll.all_reduce(PAYLOAD, GROUP, algo))
    _same(coll.all_reduce_bytes(PAYLOAD, GROUP, algo),
          jax_coll.all_reduce_bytes(PAYLOAD, GROUP, algo))
    _same(coll.dp_grad_sync(PAYLOAD, GROUP, algo),
          jax_coll.dp_grad_sync(PAYLOAD, GROUP, algo))
    _same(coll.dp_grad_sync_bytes(PAYLOAD, GROUP, algo),
          jax_coll.dp_grad_sync_bytes(PAYLOAD, GROUP, algo))
    layers = np.array([1, 24, 61])[:, None, None]
    for syncs in (2.0, 4.0):
        _same(coll.tp_act_sync(PAYLOAD, GROUP, syncs, layers, algo),
              jax_coll.tp_act_sync(PAYLOAD, GROUP, syncs, layers, algo))
        _same(coll.tp_act_sync_bytes(PAYLOAD, GROUP, syncs, layers, algo),
              jax_coll.tp_act_sync_bytes(PAYLOAD, GROUP, syncs, layers,
                                         algo))


@pytest.mark.parametrize("name", ["reduce_scatter", "all_gather",
                                  "all_to_all", "ep_dispatch_combine",
                                  "pp_boundary_bytes"])
def test_two_argument_collectives_equal(name):
    _same(getattr(coll, name)(PAYLOAD, GROUP),
          getattr(jax_coll, name)(PAYLOAD, GROUP))


def test_zero_dp_sync_equal_over_stages():
    stage = np.array([0, 1, 2, 3])[:, None, None]
    _same(coll.zero_dp_sync(PAYLOAD, GROUP, stage),
          jax_coll.zero_dp_sync(PAYLOAD, GROUP, stage))
    got = coll.zero_dp_sync(1e9, 8, 3)
    assert float(got.wire_bytes) == 3.0 * (7 / 8) * 1e9
    assert float(got.steps) == 21.0


def test_cost_arithmetic_and_errors_equal():
    a, ja = coll.all_reduce(PAYLOAD, GROUP), jax_coll.all_reduce(PAYLOAD,
                                                                 GROUP)
    b, jb = coll.all_to_all(PAYLOAD, GROUP), jax_coll.all_to_all(PAYLOAD,
                                                                 GROUP)
    _same(a + b, ja + jb)
    _same(a.scaled(3.5), ja.scaled(3.5))
    _same(a.time(50e9, 1e-5), ja.time(50e9, 1e-5))
    assert coll.canonical_algorithm("bidir") == "bidir_ring"
    assert coll.ALGORITHMS == jax_coll.ALGORITHMS
    assert coll.ALGORITHM_ALIASES == jax_coll.ALGORITHM_ALIASES
    for fn in (coll.canonical_algorithm, jax_coll.canonical_algorithm):
        with pytest.raises(ValueError, match="unknown all-reduce"):
            fn("quantum")
    for mod in (coll, jax_coll):
        with pytest.raises(ValueError, match="unknown all-reduce"):
            mod.all_reduce(1.0, 4, "quantum")
        with pytest.raises(ValueError, match="at least one"):
            mod.best_all_reduce(1.0, 4, 1e9, algorithms=())
        with pytest.raises(ValueError, match="at least one"):
            mod.best_all_reduce_grid(1.0, 4, 1e9, algorithms=())


def test_best_all_reduce_grid_equal_with_links_and_masks():
    """Per-element links (bw, α) and an ``allowed`` mask mixing auto rows
    with fixed-algorithm rows, as the planner passes them."""
    rng = np.random.default_rng(0)
    shape = (64,)
    p = 10.0 ** rng.uniform(0, 11, shape)
    n = rng.choice([1, 2, 8, 9, 16, 64, 1024], shape).astype(float)
    bw = np.where(rng.random(shape) < 0.5, 450e9, 50e9)
    alpha = np.where(rng.random(shape) < 0.5, 0.0, 10.0 ** rng.uniform(
        -7, -3, shape))
    code = rng.integers(-1, 3, shape)
    allowed = (code[None, :] < 0) | (np.arange(3)[:, None] == code[None, :])
    for kw in ({}, {"allowed": allowed}):
        got = coll.best_all_reduce_grid(p, n, bw, alpha, coll.ALGORITHMS,
                                        **kw)
        want = jax_coll.best_all_reduce_grid(p, n, bw, alpha,
                                             jax_coll.ALGORITHMS, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="allowed mask"):
        coll.best_all_reduce_grid(p, n, bw, alpha,
                                  allowed=np.zeros((3,) + shape, bool))


@settings(max_examples=30, deadline=None)
@given(payload=st.floats(min_value=1.0, max_value=1e12),
       n=st.integers(min_value=1, max_value=4096),
       bw=st.floats(min_value=1e6, max_value=1e12),
       alpha=st.floats(min_value=0.0, max_value=1e-3))
def test_property_best_all_reduce_equal(payload, n, bw, alpha):
    got, want = coll.best_all_reduce(payload, n, bw, alpha), \
        jax_coll.best_all_reduce(payload, n, bw, alpha)
    assert got[0] == want[0]
    _same(got[1], want[1])
    g = coll.best_all_reduce_grid(payload, n, bw, alpha)
    w = jax_coll.best_all_reduce_grid(payload, n, bw, alpha)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)
    assert coll.ALGORITHMS[int(g[2])] == got[0]     # the grid == the scalar


@settings(max_examples=30, deadline=None)
@given(n=st.integers(min_value=1, max_value=1024),
       bw=st.floats(min_value=1e8, max_value=1e12),
       alpha=st.floats(min_value=0.0, max_value=1e-3))
def test_property_flip_payload_equal(n, bw, alpha):
    assert coll.all_reduce_flip_payload(n, bw, alpha) == \
        jax_coll.all_reduce_flip_payload(n, bw, alpha)


@pytest.mark.parametrize("n", [7, 8, 9, 10, 16, 17])
def test_flip_payload_equal_near_the_reference_hazard(n):
    """n = 9, bw = 1e8, α ≈ 1e-3 and around it: the port answers as the
    reference does, a flip where one exists and None at the hop tie."""
    for bw in (1e8 * (1 - 1e-9), 1e8, 1e8 * (1 + 1e-9), 1.3e8):
        for alpha in np.linspace(9.9e-4, 1e-3, 5):
            got = coll.all_reduce_flip_payload(n, bw, float(alpha))
            assert got == jax_coll.all_reduce_flip_payload(n, bw,
                                                           float(alpha))
            assert (got is None) == (n in (7, 9))   # 2·⌈log2 n⌉ == n − 1
            for menu in (("ring", "tree"), ("bidir", "ring")):
                assert coll.all_reduce_flip_payload(
                    n, bw, float(alpha), menu) == \
                    jax_coll.all_reduce_flip_payload(n, bw, float(alpha),
                                                     menu)
    assert coll.all_reduce_flip_payload(n, 1e8, 0.0) is None    # α = 0
