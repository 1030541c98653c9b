"""The port's enc-dec family (``models/encdec.py``: encode, forward, the
cache, decode), its serving and its train loss, on the CPU, against the
JAX package's.

whisper-tiny at its reduced size: 2 encoder and 2 decoder layers, d 64, MHA
4/4 at dh 16, d_ff 128, a GELU FFN with biases, LayerNorm, biased
projections, learned decoder positions (``max_seq_len`` 64), 24 encoder
frames, vocab 512, tied embeddings.  Weights are numpy draws in the
reference's scanned layout (norm scales and every bias moved off their
init), carried across by ``convert.encdec_params_from_numpy``; frames and
tokens are seeded numpy.  The reference runs its plain path; the port's
``use_flash`` / ``use_kernel_matmul`` take the kernels' plain versions on
the CPU.

Tolerances, rel error = max|got - want| / max|want|, fp32: 1e-5 for encode,
the forward, the cache and every decode step's logits (the same products
in other summation orders); 1e-6 for the sinusoid table; tokens equal.
"""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import common as jax_common
from repro.models import encdec as jax_encdec
from repro.serve import engine as jax_engine
from repro.train import loop as jax_loop
from repro_torch.configs import get_reduced
from repro_torch.convert import cache_from_numpy, encdec_params_from_numpy
from repro_torch.models import common, encdec
from repro_torch.serve import engine
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

ARCH = "whisper-tiny"
TOL = 1e-5
#: B sequences; decode runs from pos 0 to MAX_LEN - 1, past the reduced
#: config's 64 learned positions; the JAX package fills PREFIX tokens' cache
B, MAX_LEN, PREFIX = 2, 80, 6
ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
FLAG_IDS = ["plain", "use_flash", "use_kernel_matmul", "both"]


def _cfgs(**kw):
    """(the reference's config, its plain path; the port's, with ``kw``)."""
    return (jax_get_reduced(ARCH).replace(compute_dtype=jnp.float32),
            get_reduced(ARCH).replace(compute_dtype=torch.float32, **kw))


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))),
                                                   1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _tree():
    """The reference ``init_encdec`` tree's structure (blocks stacked on a
    layer axis), filled from numpy."""
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda: jax_encdec.init_encdec(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        leaf = str(path[-1].key)
        n = rng.standard_normal(s.shape)
        if leaf == "scale":
            x = 1.0 + 0.1 * n
        elif leaf in ("dec_embed", "dec_pos"):
            x = 0.02 * n
        elif leaf == "bias" or leaf.startswith("b"):
            x = 0.1 * n                       # norm and projection biases
        else:                                 # (…, d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jparams():
    return jax.tree.map(jnp.asarray, _tree())


def _params():
    return encdec_params_from_numpy(_tree(), device="cpu")


def _frames(seed=1):
    _, cfg = _cfgs()
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(n, seed=2):
    _, cfg = _cfgs()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


# --- the sinusoid and the parameters -----------------------------------------

@pytest.mark.parametrize("seq, d", [(24, 64), (1500, 64), (24, 384),
                                    (1500, 384)])
def test_sinusoidal_positions_match_jax(seq, d):
    """Row ``pos`` within 1e-6 + pos x 2^-23.  XLA's fp32 ``exp`` and
    torch's differ by one ulp at some frequencies (22 of d 384's 192; none
    of d 64's 32), and the angle ``pos x frequency`` carries that ulp times
    the position into the sine: at d 384 the table reads 1.4e-6 apart at
    seq 24 and 1.2e-4 at pos 1499 (a bound of 1.8e-4 there).  d 384's
    exponent divides by d // 2 - 1 = 191, not 192."""
    got = common.sinusoidal_positions(seq, d)
    want = np.asarray(jax_common.sinusoidal_positions(seq, d))
    assert got.shape == (seq, d) and got.dtype == torch.float32
    bound = 1e-6 + np.arange(seq, dtype=np.float64)[:, None] * 2.0 ** -23
    assert np.all(np.abs(got.numpy() - want) <= bound)
    if d == 384:   # row 1, column 2: sin(1 x exp(-2 log(1e4) / 191))
        assert abs(float(got[1, 2])
                   - np.sin(np.exp(-2 * np.log(1e4) / 191))) < 1e-6


def test_init_encdec_has_the_reference_structure():
    jcfg, cfg = _cfgs()
    params = encdec.init_encdec(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    shapes = jax.eval_shape(lambda: jax_encdec.init_encdec(
        jax.random.PRNGKey(0), jcfg))
    for side, n in (("enc_blocks", cfg.encoder_layers),
                    ("dec_blocks", cfg.n_layers)):
        want = jax.tree.map(lambda s: s.shape[1:], shapes[side])
        assert len(params[side]) == n
        for blk in params[side]:
            assert jax.tree.map(lambda t: tuple(t.shape), blk) == want
    for name in ("enc_norm", "dec_embed", "dec_pos", "dec_norm"):
        assert jax.tree.map(lambda t: tuple(t.shape), params[name]) == \
            jax.tree.map(lambda s: s.shape, shapes[name])
    assert common.count_params(params) == \
        jax.tree_util.tree_reduce(lambda n, s: n + s.size, shapes, 0)


# --- encode and forward -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_forward():
    jcfg, _ = _cfgs()
    frames, toks = _frames(), _tokens(20)
    enc = jax.jit(lambda p, f: jax_encdec.encode(p, f, jcfg))(
        _jparams(), jnp.asarray(frames))
    logits, aux = jax.jit(lambda p, t, f: jax_encdec.forward(p, t, f, jcfg))(
        _jparams(), jnp.asarray(toks), jnp.asarray(frames))
    return _np(enc), _np(logits), float(aux)


@pytest.mark.parametrize("flash, kmm", FLAGS, ids=FLAG_IDS)
def test_encode_and_forward_match_jax(flash, kmm):
    _, cfg = _cfgs(use_flash=flash, use_kernel_matmul=kmm)
    want_enc, want_logits, want_aux = _jax_forward()
    params = _params()
    frames = torch.from_numpy(_frames())
    enc = encdec.encode(params, frames, cfg)
    assert enc.shape == frames.shape and enc.dtype == torch.float32
    assert _rel_err(_np(enc), want_enc) < TOL
    logits, aux = encdec.forward(params, torch.from_numpy(_tokens(20)).long(),
                                 frames, cfg)
    assert logits.shape == (B, 20, cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == want_aux == 0.0
    assert _rel_err(_np(logits), want_logits) < TOL


def test_the_encoder_sees_every_frame():
    """The encoder is bidirectional: a change in the last frame moves the
    first frame's state (a causal mask would leave it as it was)."""
    _, cfg = _cfgs(use_flash=True)
    params = _params()
    frames = torch.from_numpy(_frames())
    moved = frames.clone()
    moved[:, -1] += 1.0
    a, b = (encdec.encode(params, f, cfg) for f in (frames, moved))
    assert not torch.allclose(a[:, 0], b[:, 0])


# --- the cache and decode -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode():
    """JAX's cache for the frames, then its decode over every position
    0 … MAX_LEN - 1: the cache after ``PREFIX`` tokens, each step's logits
    and the final cache."""
    jcfg, _ = _cfgs()
    params = _jparams()
    step = jax.jit(lambda p, t, c, pos: jax_encdec.decode_step(
        p, t, c, pos, jcfg))
    toks = _tokens(MAX_LEN, seed=3)
    cache = jax_encdec.init_encdec_cache(params, jnp.asarray(_frames()), B,
                                         MAX_LEN, jcfg)
    first = jax.tree.map(np.asarray, cache)
    logits, prefix = [], None
    for t in range(MAX_LEN):
        if t == PREFIX:
            prefix = jax.tree.map(np.asarray, cache)
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        logits.append(_np(lg))
    return first, prefix, logits, jax.tree.map(np.asarray, cache)


def _assert_cache_close(cache, want):
    assert set(cache) == {"self", "cross_k", "cross_v"}
    for got, ref in zip(tree_leaves(cache), jax.tree.leaves(want)):
        assert tuple(got.shape) == ref.shape and got.dtype == torch.float32
        assert _rel_err(_np(got), ref) < TOL


def test_init_encdec_cache_matches_jax_leaf_by_leaf():
    first = _jax_decode()[0]
    _, cfg = _cfgs(use_flash=True, use_kernel_matmul=True)
    cache = encdec.init_encdec_cache(_params(), torch.from_numpy(_frames()),
                                     B, MAX_LEN, cfg)
    assert cache["cross_k"].shape == (cfg.n_layers, B, cfg.encoder_seq,
                                      cfg.n_kv_heads, cfg.dh)
    assert not cache["self"]["k"].any() and not cache["self"]["v"].any()
    _assert_cache_close(cache, first)


@pytest.mark.parametrize("kmm", [False, True], ids=["plain",
                                                     "use_kernel_matmul"])
def test_decode_step_matches_jax_past_the_position_table(kmm):
    """Every step from pos 0 to 79 on a cache of 80: the steps at pos 64 …
    79 read the last learned position row, as the reference clamps it."""
    first, _, want_logits, want_cache = _jax_decode()
    _, cfg = _cfgs(use_flash=True, use_kernel_matmul=kmm)
    assert cfg.max_seq_len < MAX_LEN
    params = _params()
    cache = encdec.init_encdec_cache(params, torch.from_numpy(_frames()), B,
                                     MAX_LEN, cfg)
    cross = cache["cross_k"].clone()
    toks = torch.from_numpy(_tokens(MAX_LEN, seed=3)).long()
    for t in range(MAX_LEN):
        logits, out = encdec.decode_step(params, toks[:, t:t + 1], cache, t,
                                         cfg)
        assert out is cache and logits.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(logits), want_logits[t]) < TOL, t
    assert torch.equal(cache["cross_k"], cross)
    _assert_cache_close(cache, want_cache)


def test_decode_from_a_jax_filled_cache():
    """``convert.cache_from_numpy`` carries the reference's enc-dec cache
    after ``PREFIX`` steps over; the port goes on from it."""
    _, prefix, want_logits, want_cache = _jax_decode()
    _, cfg = _cfgs()
    params = _params()
    cache = cache_from_numpy(prefix, device="cpu")
    assert cache["self"]["k"].shape == (cfg.n_layers, B, MAX_LEN,
                                        cfg.n_kv_heads, cfg.dh)
    assert cache["self"]["k"][:, :, PREFIX - 1].any()
    toks = torch.from_numpy(_tokens(MAX_LEN, seed=3)).long()
    for t in range(PREFIX, PREFIX + 8):
        logits, _ = encdec.decode_step(params, toks[:, t:t + 1], cache, t,
                                       cfg)
        assert _rel_err(_np(logits), want_logits[t]) < TOL, t


def test_decode_matches_the_ports_forward():
    """Teacher-forced decode against the port's own forward (the
    reference's own bounds, ``tests/test_serve.py``: atol 2e-4, rtol 1e-3)."""
    _, cfg = _cfgs()
    params = _params()
    frames = torch.from_numpy(_frames())
    toks = torch.from_numpy(_tokens(12, seed=4)).long()
    full, _ = encdec.forward(params, toks, frames, cfg)
    cache = encdec.init_encdec_cache(params, frames, B, 12, cfg)
    rows = [encdec.decode_step(params, toks[:, t:t + 1], cache, t, cfg)[0]
            for t in range(12)]
    np.testing.assert_allclose(_np(torch.cat(rows, dim=1)), _np(full),
                               atol=2e-4, rtol=1e-3)


# --- serving ----------------------------------------------------------------------

def test_greedy_generate_matches_jax_token_for_token():
    jcfg, cfg = _cfgs(use_flash=True, use_kernel_matmul=True)
    prompt, frames = _tokens(4, seed=5), _frames(seed=6)
    want = jax_engine.greedy_generate(_jparams(), jcfg, jnp.asarray(prompt),
                                      steps=6, max_len=10,
                                      frames=jnp.asarray(frames))
    got = engine.greedy_generate(_params(), cfg,
                                 torch.from_numpy(prompt).long(), steps=6,
                                 max_len=10, frames=torch.from_numpy(frames))
    assert got.shape == (B, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="frames"):
        engine.greedy_generate(_params(), cfg,
                               torch.from_numpy(prompt).long(), steps=1,
                               max_len=5)


def test_cli_fails_without_frames_as_the_reference_does():
    """The CLI passes no encoder frames (nor does the reference's, which
    ends in an AssertionError): it exits nonzero with the engine's
    message."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "3",
         "--new-tokens", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "needs the encoder's frames" in out.stderr
    assert "first sequence" not in out.stdout


# --- the train loss ---------------------------------------------------------------

def test_encdec_loss_and_grads_match_jax():
    """``make_loss_fn``'s enc-dec loss and its grads against
    ``jax.value_and_grad`` of the reference's, each grad within 1e-5 of its
    own largest value."""
    jcfg, cfg = _cfgs()
    toks = _tokens(16, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": _frames(seed=8)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jax_loop.make_loss_fn(jcfg), has_aux=True))(
            _jparams(), jax.tree.map(jnp.asarray, batch))
    params = _params()
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, met = loop.make_loss_fn(cfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) < TOL * abs(float(jloss))
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    want = encdec_params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                    device="cpu")
    _assert_grads_close(grads, tree_leaves(want))


def _assert_grads_close(grads, want):
    """Each grad within 1e-5 of its own largest value, floored at 1e-3 of
    the largest grad in the tree: the key projections' biases have a zero
    grad in exact arithmetic (a softmax does not see a shift shared by all
    its keys), and both sides compute rounding noise there (~1e-10)."""
    top = max(float(w.abs().max()) for w in want)
    for g, w in zip(grads, want, strict=True):
        assert g.shape == w.shape
        denom = max(float(w.abs().max()), 1e-3 * top)
        assert float((g - w).abs().max()) / denom < TOL
