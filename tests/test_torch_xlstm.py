"""The port's xLSTM blocks (``models/ssm.py``) and the ssm family in
forward, decode and serving, on the CPU, against the JAX package's.

xlstm-125m at its reduced size: 3 layers (sLSTM at layer 1, mLSTM at 0 and
2), d 48, 2 heads (the mLSTM's inner width 96: dh 48), tied vocab 512, no
position embedding, ``ssm_chunk`` 8.  Weights are numpy draws in the
reference's layout (a list of per-layer trees that differ), norm scales,
``skip_scale``, ``b_if``, ``r_diag`` and ``b`` moved off their init;
inputs are seeded numpy.

Tolerances, rel error = max|got - want| / max|want|:
  * a block or cell, fp32: 1e-5; the whole forward 1e-4 and each decode
    step's logits 1e-5, the states after each step 1e-5.
  * bf16: a block within 3e-2, the forward within 5e-2 (each side rounds
    every product's output to bf16, in other orders).
  * decode against the port's own forward: the reference's own bounds
    (``tests/test_serve.py``: atol 2e-4, rtol 1e-3).
"""
import functools
import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common, ssm, transformer
from repro_torch.serve import engine

ARCH = "xlstm-125m"
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: decode: B sequences of STEPS tokens; the JAX package fills PREFIX
B, STEPS, PREFIX = 2, 12, 5


def _cfgs(dtype="float32", **kw):
    return (jax_get_reduced(ARCH).replace(compute_dtype=JNP[dtype], **kw),
            get_reduced(ARCH).replace(compute_dtype=TORCH[dtype], **kw))


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))),
                                                   1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tree():
    """The reference ``init_lm`` tree's structure (a list of blocks), filled
    from numpy."""
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape)
        if "scale" in name:
            x = 1.0 + 0.1 * n
        elif any(t in name for t in ("'b_if'", "'b'", "r_diag")):
            x = 0.5 * n
        elif "embed" in name:
            x = 0.02 * n
        else:                                  # (d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _block_params(layer):
    return lm_params_from_numpy({"blocks": [_tree()["blocks"][layer]]},
                                device="cpu")["blocks"][0]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- mLSTM ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 20])
def test_apply_mlstm_matches_jax(S, dtype):
    """S = 16 (two chunks of 8) and 20 (four of 5)."""
    jcfg, cfg = _cfgs(dtype)
    x = _x((B, S, cfg.d_model), S)
    tree = _tree()["blocks"][0]["mlstm"]
    want = jax.jit(lambda p, x: jax_ssm.apply_mlstm(p, x, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x).astype(JNP[dtype]))
    got = ssm.apply_mlstm(_block_params(0)["mlstm"],
                          torch.from_numpy(x).to(TORCH[dtype]), cfg)
    assert got.shape == x.shape and got.dtype == TORCH[dtype]
    assert _rel_err(_np(got), _np(want)) < {"float32": 1e-5,
                                             "bfloat16": 3e-2}[dtype]


def test_mlstm_scale_is_sqrt_dh_rounded_to_the_compute_dtype():
    """xlstm-125m's heads are dh 384: the reference divides q and k by
    ``jnp.sqrt(384).astype(bf16)`` = 19.625, not by 19.596.  The port must
    divide by the same bf16 value (``attention._scale``)."""
    jcfg, cfg = _cfgs("bfloat16", d_model=768, n_heads=4)
    assert ssm._heads(cfg) == (4, 384)
    assert float(jnp.sqrt(384).astype(jnp.bfloat16)) == 19.625
    rng = np.random.default_rng(5)
    D, Di = 768, 1536
    p = {n: torch.from_numpy((rng.standard_normal(s) / math.sqrt(s[0]))
                             .astype(np.float32))
         for n, s in (("w_up", (D, Di)), ("w_gate", (D, Di)),
                      ("wq", (Di, Di)), ("wk", (Di, Di)), ("wv", (Di, Di)),
                      ("w_if", (Di, 8)))}
    p["b_if"] = torch.zeros(8)
    x = torch.from_numpy(_x((1, 3, D), 6)).to(torch.bfloat16)
    u, _, q, _, _, _ = ssm._mlstm_qkvg(p, x, cfg)
    raw = (u @ p["wq"].to(torch.bfloat16)).reshape(1, 3, 4, 384)
    assert torch.equal(q, raw / torch.tensor(19.625, dtype=torch.bfloat16))
    assert not torch.equal(q, raw / math.sqrt(384))
    jq = jax_ssm._mlstm_qkvg(jax.tree.map(lambda t: jnp.asarray(t.numpy()), p),
                             jnp.asarray(x.float().numpy()).astype(
                                 jnp.bfloat16), jcfg)[2]
    assert _rel_err(_np(q), _np(jq)) < 2e-2


def test_decode_mlstm_matches_jax_and_the_prefill():
    jcfg, cfg = _cfgs()
    x = _x((B, 10, cfg.d_model), 7)
    p = _block_params(0)["mlstm"]
    jp = jax.tree.map(jnp.asarray, _tree()["blocks"][0]["mlstm"])
    st = ssm.init_mlstm_state(cfg, B, device="cpu")
    jst = jax_ssm.init_mlstm_state(jcfg, B)
    assert st[0].shape == jst[0].shape and st[1].shape == jst[1].shape
    ys = []
    for t in range(10):
        y, st = ssm.decode_mlstm(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        jy, jst = jax_ssm.decode_mlstm(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                       jcfg)
        assert _rel_err(_np(y), _np(jy)) < 1e-5
        ys.append(y)
    assert _rel_err(_np(st[0]), _np(jst[0])) < 1e-5
    assert _rel_err(_np(st[1]), _np(jst[1])) < 1e-5
    full = ssm.apply_mlstm(p, torch.from_numpy(x), cfg)
    assert _rel_err(_np(torch.cat(ys, 1)), _np(full)) < 1e-5


# --- sLSTM ----------------------------------------------------------------------

def test_slstm_cell_matches_jax_from_a_drawn_state():
    """One step from a state off its init (m far from -10, n near 0 and
    negative, so the stabilizer and the |n| clamp both act)."""
    jcfg, cfg = _cfgs()
    D = cfg.d_model
    rng = np.random.default_rng(8)
    state = {"c": rng.standard_normal((B, D)), "n": 0.5 * rng.standard_normal((B, D)),
             "h": rng.standard_normal((B, D)), "m": rng.standard_normal((B, D))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    xw = _x((B, 4 * D), 9)
    tree = _tree()["blocks"][1]["slstm"]
    want = jax_ssm._slstm_cell(jax.tree.map(jnp.asarray, tree),
                               jax.tree.map(jnp.asarray, state),
                               jnp.asarray(xw), jcfg)
    got = ssm._slstm_cell(_block_params(1)["slstm"],
                          {k: torch.from_numpy(v) for k, v in state.items()},
                          torch.from_numpy(xw), cfg)
    assert set(got) == {"c", "n", "h", "m"}
    for k in got:
        assert got[k].dtype == torch.float32
        assert _rel_err(_np(got[k]), _np(want[k])) < 1e-5, k


def test_init_slstm_state_matches_jax():
    jcfg, cfg = _cfgs()
    st = ssm.init_slstm_state(cfg, 3, device="cpu")
    want = jax_ssm.init_slstm_state(jcfg, 3)
    for k in ("c", "n", "h", "m"):
        np.testing.assert_array_equal(_np(st[k]), _np(want[k]))
    assert float(st["m"][0, 0]) == -10.0
    assert len({t.data_ptr() for t in st.values()}) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 13])
def test_apply_slstm_matches_jax(S, dtype):
    """S = 16 (the reference's two time chunks of 8) and 13 (one chunk):
    the chunking of the reference changes where ``w_x`` is applied, not the
    values."""
    jcfg, cfg = _cfgs(dtype)
    x = _x((B, S, cfg.d_model), 10 + S)
    tree = _tree()["blocks"][1]["slstm"]
    want = jax.jit(lambda p, x: jax_ssm.apply_slstm(p, x, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x).astype(JNP[dtype]))
    got = ssm.apply_slstm(_block_params(1)["slstm"],
                          torch.from_numpy(x).to(TORCH[dtype]), cfg)
    assert got.shape == x.shape and got.dtype == TORCH[dtype]
    assert _rel_err(_np(got), _np(want)) < {"float32": 1e-5,
                                             "bfloat16": 3e-2}[dtype]


def test_slstm_geglu_is_the_tanh_gelu():
    """``jax.nn.gelu`` is the tanh form: the erf form moves the output."""
    _, cfg = _cfgs()
    p = _block_params(1)["slstm"]
    h = torch.from_numpy(_x((B, 1, cfg.d_model), 11))
    a, b = torch.chunk(h @ p["w_ffn_up"], 2, dim=-1)
    tanh = (torch.nn.functional.gelu(a, approximate="tanh") * b) \
        @ p["w_ffn_down"]
    erf = (torch.nn.functional.gelu(a) * b) @ p["w_ffn_down"]
    got = ssm._geglu(p, h, cfg)
    assert torch.equal(got, tanh) and not torch.equal(got, erf)


def test_decode_slstm_matches_jax_and_the_prefill():
    jcfg, cfg = _cfgs()
    x = _x((B, 9, cfg.d_model), 12)
    p = _block_params(1)["slstm"]
    jp = jax.tree.map(jnp.asarray, _tree()["blocks"][1]["slstm"])
    st = ssm.init_slstm_state(cfg, B, device="cpu")
    jst = jax_ssm.init_slstm_state(jcfg, B)
    ys = []
    for t in range(9):
        y, st = ssm.decode_slstm(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        jy, jst = jax_ssm.decode_slstm(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                       jcfg)
        assert _rel_err(_np(y), _np(jy)) < 1e-5
        ys.append(y)
    for k in st:
        assert _rel_err(_np(st[k]), _np(jst[k])) < 1e-5, k
    full = ssm.apply_slstm(p, torch.from_numpy(x), cfg)
    assert _rel_err(_np(torch.cat(ys, 1)), _np(full)) < 1e-5


# --- the model ------------------------------------------------------------------

def test_init_lm_has_the_reference_structure():
    """A list of blocks that differ: mLSTM at 0 and 2, sLSTM at 1; tied, no
    position table; the full config's too, by shape."""
    for jcfg, cfg in (_cfgs(), (jax_get_reduced(ARCH).replace(
            d_model=96, n_heads=4), get_reduced(ARCH).replace(
            d_model=96, n_heads=4))):
        params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
        shapes = jax.eval_shape(
            lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
        assert jax.tree.map(lambda t: tuple(t.shape), params) == \
            jax.tree.map(lambda s: s.shape, shapes)
        assert ["slstm" in b for b in params["blocks"]] == [False, True, False]
        assert "lm_head" not in params and "pos_embed" not in params
        assert common.count_params(params) == \
            jax.tree_util.tree_reduce(lambda n, s: n + s.size, shapes, 0)


def test_heterogeneous_blocks_convert_layer_by_layer():
    tree = _tree()
    params = lm_params_from_numpy(tree, device="cpu")
    assert isinstance(tree["blocks"], list)
    for blk, want in zip(params["blocks"], tree["blocks"], strict=True):
        assert set(blk) == set(want)
        for a, b in zip(jax.tree.leaves(blk), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    """S = 24: three chunks of 8 in the mLSTM blocks, 24 sLSTM steps."""
    jcfg, cfg = _cfgs(dtype)
    toks = _tokens(cfg.vocab_size, (B, 24), 1)
    want, jaux = jax.jit(lambda p, t: jax_tf.forward(p, t, jcfg))(
        jax.tree.map(jnp.asarray, _tree()), jnp.asarray(toks))
    got, aux = transformer.forward(lm_params_from_numpy(_tree(), device="cpu"),
                                   torch.from_numpy(toks), cfg)
    assert got.shape == (B, 24, cfg.vocab_size) and got.dtype == TORCH[dtype]
    assert float(aux) == float(jaux) == 0.0
    assert _rel_err(_np(got), _np(want)) < {"float32": 1e-4,
                                             "bfloat16": 5e-2}[dtype]


# --- decode and serving -----------------------------------------------------------

def test_cache_layout_matches_jax():
    jcfg, cfg = _cfgs()
    cache = transformer.init_cache(cfg, B, 7, device="cpu")
    want = jax_tf.init_cache(jcfg, B, 7)
    assert jax.tree.map(lambda t: tuple(t.shape), cache) == \
        jax.tree.map(lambda a: a.shape, want)
    assert set(cache["layer1"]) == {"c", "n", "h", "m"}
    assert set(cache["layer0"]) == set(cache["layer2"]) == {"M", "n"}
    for name, row in cache.items():
        for k, t in row.items():
            np.testing.assert_array_equal(_np(t), _np(want[name][k]))


@functools.lru_cache(maxsize=None)
def _jax_decode():
    jcfg, _ = _cfgs()
    params = jax.tree.map(jnp.asarray, _tree())
    step = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(p, t, c, pos, jcfg))
    toks = _tokens(jcfg.vocab_size, (B, STEPS), 2)
    cache = jax_tf.init_cache(jcfg, B, STEPS)
    logits, caches, prefix_cache = [], [], None
    for t in range(STEPS):
        if t == PREFIX:
            prefix_cache = jax.tree.map(np.asarray, cache)
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        logits.append(_np(lg))
        caches.append(jax.tree.map(np.asarray, cache))
    return prefix_cache, logits, caches


def _assert_cache_close(cache, want, tol=1e-5):
    for name, row in want.items():
        for k, w in row.items():
            assert _rel_err(_np(cache[name][k]), w) < tol, (name, k)


def test_decode_step_matches_jax_per_token():
    _, want_logits, want_caches = _jax_decode()
    _, cfg = _cfgs()
    params = lm_params_from_numpy(_tree(), device="cpu")
    cache = transformer.init_cache(cfg, B, STEPS, device="cpu")
    rows = {k: cache[k] for k in cache}
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, STEPS), 2)).long()
    for t in range(STEPS):
        logits, out = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                              t, cfg)
        assert out is cache and all(cache[k] is rows[k] for k in rows)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(logits), want_logits[t]) < 1e-5, t
        _assert_cache_close(cache, want_caches[t])


def test_decode_continues_from_a_jax_cache():
    prefix_cache, want_logits, want_caches = _jax_decode()
    _, cfg = _cfgs()
    params = lm_params_from_numpy(_tree(), device="cpu")
    cache = cache_from_numpy(prefix_cache, device="cpu")
    for name, row in prefix_cache.items():
        for k, w in row.items():
            np.testing.assert_array_equal(_np(cache[name][k]), w)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, STEPS), 2)).long()
    for t in range(PREFIX, STEPS):
        logits, cache = transformer.decode_step(params, toks[:, t:t + 1],
                                                cache, t, cfg)
        assert _rel_err(_np(logits), want_logits[t]) < 1e-5, t
    _assert_cache_close(cache, want_caches[-1])


def test_decode_matches_the_ports_forward():
    _, cfg = _cfgs()
    params = lm_params_from_numpy(_tree(), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, 18), 3)).long()
    full, _ = transformer.forward(params, toks, cfg)
    cache = engine.init_cache(params, cfg, B, 18)
    step = engine.build_serve_step(cfg)
    rows = [step(params, toks[:, t:t + 1], cache, t)[0][:, 0]
            for t in range(18)]
    np.testing.assert_allclose(_np(torch.stack(rows, 1)), _np(full),
                               atol=2e-4, rtol=1e-3)


def test_greedy_generate_matches_jax():
    jcfg, cfg = _cfgs()
    prompt = _tokens(cfg.vocab_size, (B, 4), 4)
    want = jax_engine.greedy_generate(jax.tree.map(jnp.asarray, _tree()), jcfg,
                                      jnp.asarray(prompt), steps=6,
                                      max_len=10)
    got = engine.greedy_generate(lm_params_from_numpy(_tree(), device="cpu"),
                                 cfg, torch.from_numpy(prompt).long(),
                                 steps=6, max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_generates_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3",
                           "--new-tokens", "4", "--seed", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(re.escape(ARCH) + r": batch=2 \+4 tokens in "
                        r"[0-9.]+s \([0-9]+ tok/s\)", out[0])
    seq = json.loads(out[1].removeprefix("first sequence: "))
    assert len(seq) == 7 and all(0 <= t < 512 for t in seq)

