"""The port's SSD recurrence (``models/ssd.py``) and Mamba heads
(``models/mamba.py``) on the CPU, against the JAX package's.

Inputs are seeded numpy arrays, the same into both packages; the Mamba
weights are numpy draws in the reference's ``init_mamba`` structure (its
zero and one leaves moved off their init).

Tolerances, rel error = max|got - want| / max|want|:
  * fp32: 1e-5 (the same products and exps in other summation orders; the
    port composes the chunk states in a loop where the reference runs an
    associative scan, which rounds in another order).
  * the chunked form against the sequential ``decode_linear_step`` run
    token by token: 1e-5 in fp32, the same sums in another association.
  * bf16 (the scores and the intra-chunk product in bf16, the rest fp32):
    2e-2, a few bf16 roundings (2^-8 each) of the inputs and scores.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import mamba as jax_mamba
from repro.models import ssd as jax_ssd
from repro_torch.configs import get_reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import mamba, ssd

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, H, DK, DV = 2, 3, 4, 5


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))),
                                                   1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(T, seed, dtype="float32"):
    """q, k, v (B, T, H, d) and log decays in [-0.7, -0.01]."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, DK)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, DV)).astype(np.float32)
    la = -rng.uniform(0.01, 0.7, (B, T, H)).astype(np.float32)
    if dtype == "bfloat16":        # the same bf16 values on both sides
        q, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, k, v))
    return q, k, v, la


def _state(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, DK, DV)).astype(np.float32),
            rng.standard_normal((B, H, DK)).astype(np.float32))


#: the reference's recurrence compiled whole (one compile a shape, where
#: its eager ops compile one by one)
_jax_chunked = jax.jit(jax_ssd.chunked_linear_recurrence,
                       static_argnames=("chunk", "normalize"))


def _both(q, k, v, la, dtype, chunk, normalize, state):
    jt = lambda a: jnp.asarray(a).astype(JNP[dtype])          # noqa: E731
    tt = lambda a: torch.tensor(a).to(TORCH[dtype])           # noqa: E731
    want = _jax_chunked(
        jt(q), jt(k), jt(v), jnp.asarray(la), chunk=chunk,
        normalize=normalize,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    got = ssd.chunked_linear_recurrence(
        tt(q), tt(k), tt(v), torch.from_numpy(la), chunk=chunk,
        normalize=normalize,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    return got, want


# --- chunked_linear_recurrence ------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_recurrence_matches_jax(chunk, normalize, with_state):
    """T = 32: 8, 4 and 2 chunks."""
    q, k, v, la = _inputs(32, chunk)
    state = _state(chunk + 1) if with_state else None
    (y, (M, n)), (jy, (jM, jn)) = _both(q, k, v, la, "float32", chunk,
                                        normalize, state)
    assert y.shape == (B, 32, H, DV) and y.dtype == torch.float32
    assert M.dtype == n.dtype == torch.float32
    assert _rel_err(_np(y), _np(jy)) < TOL["float32"]
    assert _rel_err(_np(M), _np(jM)) < TOL["float32"]
    assert _rel_err(_np(n), _np(jn)) < TOL["float32"]


@pytest.mark.parametrize("T, chunk, L", [(20, 8, 5), (21, 16, 7), (13, 4, 1)])
def test_chunk_falls_back_to_the_largest_divisor(T, chunk, L):
    """T not divisible by the chunk: both take the largest divisor of T
    below it (L); a prime T runs chunks of 1."""
    q, k, v, la = _inputs(T, T)
    for normalize in (False, True):
        (y, (M, n)), (jy, (jM, jn)) = _both(q, k, v, la, "float32", chunk,
                                            normalize, _state(T))
        assert _rel_err(_np(y), _np(jy)) < TOL["float32"]
        assert _rel_err(_np(M), _np(jM)) < TOL["float32"]
        assert _rel_err(_np(n), _np(jn)) < TOL["float32"]
        # the same values as one chunk of exactly L steps
        y_l, _ = ssd.chunked_linear_recurrence(
            *(torch.from_numpy(a) for a in (q, k, v, la)), chunk=L,
            normalize=normalize, state=tuple(map(torch.from_numpy,
                                                 _state(T))))
        assert torch.equal(y, y_l)


def test_without_normalize_the_incoming_n_comes_back():
    """The reference carries no normalizer when ``normalize`` is off: the
    n it returns is the one it was given."""
    q, k, v, la = _inputs(16, 3)
    state = tuple(map(torch.from_numpy, _state(4)))
    _, (_, n) = ssd.chunked_linear_recurrence(
        *(torch.from_numpy(a) for a in (q, k, v, la)), chunk=4, state=state)
    assert n is state[1]


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "norm"])
def test_chunked_recurrence_bf16_matches_jax(normalize):
    q, k, v, la = _inputs(32, 7, "bfloat16")
    (y, (M, n)), (jy, (jM, jn)) = _both(q, k, v, la, "bfloat16", 8,
                                        normalize, None)
    assert y.dtype == torch.bfloat16 and M.dtype == torch.float32
    assert _rel_err(_np(y), _np(jy)) < TOL["bfloat16"]
    assert _rel_err(_np(M), _np(jM)) < TOL["bfloat16"]


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_form_equals_the_sequential_steps(chunk, normalize):
    """The port's chunked prefill against its own ``decode_linear_step``
    token by token (and the reference's), from a carried state."""
    T = 24
    q, k, v, la = _inputs(T, 11 + chunk)
    state = _state(12)
    y, (M, n) = ssd.chunked_linear_recurrence(
        *(torch.from_numpy(a) for a in (q, k, v, la)), chunk=chunk,
        normalize=normalize, state=tuple(map(torch.from_numpy, state)))
    st = tuple(map(torch.from_numpy, state))
    jst = tuple(map(jnp.asarray, state))
    ys, jys = [], []
    for t in range(T):
        yt, st = ssd.decode_linear_step(
            st, *(torch.from_numpy(a[:, t]) for a in (q, k, v)),
            torch.exp(torch.from_numpy(la[:, t])), normalize=normalize)
        jyt, jst = jax_ssd.decode_linear_step(
            jst, *(jnp.asarray(a[:, t]) for a in (q, k, v)),
            jnp.exp(jnp.asarray(la[:, t])), normalize=normalize)
        assert _rel_err(_np(yt), _np(jyt)) < TOL["float32"]
        ys.append(yt)
        jys.append(jyt)
    assert _rel_err(_np(y), _np(torch.stack(ys, 1))) < TOL["float32"]
    assert _rel_err(_np(M), _np(st[0])) < TOL["float32"]
    assert _rel_err(_np(st[0]), _np(jst[0])) < TOL["float32"]
    assert _rel_err(_np(st[1]), _np(jst[1])) < TOL["float32"]
    if normalize:
        assert _rel_err(_np(n), _np(st[1])) < TOL["float32"]


def test_decode_step_leaves_its_input_state_alone():
    st = tuple(map(torch.from_numpy, _state(5)))
    before = [s.clone() for s in st]
    q, k, v, la = _inputs(1, 6)
    _, new = ssd.decode_linear_step(
        st, *(torch.from_numpy(a[:, 0]) for a in (q, k, v)),
        torch.exp(torch.from_numpy(la[:, 0])), normalize=True)
    assert all(torch.equal(a, b) for a, b in zip(st, before))
    assert not torch.equal(new[0], st[0])


def test_init_linear_state_layout_and_device():
    M, n = ssd.init_linear_state(2, 3, 4, 5, device="cpu")
    jM, jn = jax_ssd.init_linear_state(2, 3, 4, 5)
    assert M.shape == jM.shape and n.shape == jn.shape
    assert M.dtype == n.dtype == torch.float32 and not M.any() and not n.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ssd.init_linear_state(2, 3, 4, 5)


# --- Mamba heads --------------------------------------------------------------

def _cfgs(dtype="float32"):
    return (jax_get_reduced("hymba-1.5b").replace(compute_dtype=JNP[dtype]),
            get_reduced("hymba-1.5b").replace(compute_dtype=TORCH[dtype]))


@functools.lru_cache(maxsize=None)
def _mamba_tree():
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(
        lambda: jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape)
        if "D_skip" in name:
            x = 1.0 + 0.1 * n
        elif "b_dt" in name or "A_log" in name:
            x = 0.3 * n
        else:
            x = n / np.sqrt(s.shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _mamba_params():
    return lm_params_from_numpy({"blocks": [_mamba_tree()]},
                                device="cpu")["blocks"][0]


def test_init_mamba_has_the_reference_structure():
    jcfg, cfg = _cfgs()
    p = mamba.init_mamba(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(lambda s: s.shape, jax.eval_shape(
        lambda: jax_mamba.init_mamba(jax.random.PRNGKey(0), jcfg)))
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert not p["A_log"].any() and not p["b_dt"].any()
    assert torch.equal(p["D_skip"], torch.ones_like(p["D_skip"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_matches_jax(dtype):
    """S = 20 with ``ssm_chunk`` 8: chunks of 5."""
    jcfg, cfg = _cfgs(dtype)
    x = np.random.default_rng(3).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_mamba.apply_mamba(p, x, jcfg))(
        jax.tree.map(jnp.asarray, _mamba_tree()), jnp.asarray(x))
    got = mamba.apply_mamba(_mamba_params(), torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == TORCH[dtype]
    assert _rel_err(_np(got), _np(want)) < TOL[dtype]


def test_decode_mamba_matches_jax_and_the_prefill():
    """Token by token from the zero state: each step against the
    reference's, and the steps together against the port's prefill."""
    jcfg, cfg = _cfgs()
    x = np.random.default_rng(4).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    p, jp = _mamba_params(), jax.tree.map(jnp.asarray, _mamba_tree())
    st = mamba.init_mamba_state(cfg, 2, device="cpu")
    jst = jax_mamba.init_mamba_state(jcfg, 2)
    assert st[0].shape == jst[0].shape and st[1].shape == jst[1].shape
    ys = []
    for t in range(12):
        y, st = mamba.decode_mamba(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        jy, jst = jax_mamba.decode_mamba(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                         jcfg)
        assert _rel_err(_np(y), _np(jy)) < TOL["float32"]
        ys.append(y)
    assert _rel_err(_np(st[0]), _np(jst[0])) < TOL["float32"]
    assert _rel_err(_np(st[1]), _np(jst[1])) < TOL["float32"]
    full = mamba.apply_mamba(p, torch.from_numpy(x), cfg)
    assert _rel_err(_np(torch.cat(ys, 1)), _np(full)) < TOL["float32"]
