"""The port's Hymba blocks (``models/hybrid.py``) and the hybrid family in
forward, decode and serving, on the CPU, against the JAX package's.

hymba-1.5b at its reduced size: 3 layers, d 64, GQA 4/2 at dh 16, d_ff
128, ssm_state 4, ``ssm_chunk`` 8, sliding window 8 but in the global
layers (0, 2).  Weights are numpy draws in the reference's scanned layout
(norm scales, the fusion's β, ``D_skip``, ``b_dt`` and ``A_log`` moved off
their init), carried across by ``convert.lm_params_from_numpy``; inputs are
seeded numpy.

Tolerances, rel error = max|got - want| / max|want|:
  * a block, fp32: 1e-5; the whole forward and each decode step's logits,
    fp32: 1e-4 and 1e-5 (the bounds of ``tests/test_torch_moe.py``), the
    cache after each step 1e-5.
  * bf16: a block within 3e-2, the forward within 5e-2: each side rounds
    every product's output and the fusion to bf16, in other orders, and
    the residual stream carries the differences through the layers.
  * decode against the port's own forward: the reference's own bounds
    (``tests/test_serve.py``: atol 2e-4, rtol 1e-3).
"""
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import hybrid as jax_hybrid
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common, hybrid, transformer
from repro_torch.serve import engine

ARCH = "hymba-1.5b"
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: decode: B sequences against a cache of MAX_LEN (the window of 8 wraps
#: after 8 steps); the JAX package fills the first PREFIX tokens
B, MAX_LEN, PREFIX = 2, 14, 10


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
    """The reference ``init_lm`` tree's structure (blocks stacked on a
    layer axis), filled from numpy."""
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape)
        if any(t in name for t in ("scale", "beta", "D_skip")):
            x = 1.0 + 0.1 * n
        elif "b_dt" in name or "A_log" in name:
            x = 0.3 * n
        elif "embed" in name:
            x = 0.02 * n
        else:                                  # (…, d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _block_tree(layer):
    return jax.tree.map(lambda a: np.asarray(a[layer]), _tree()["blocks"])


def _block_params(layer):
    return lm_params_from_numpy({"blocks": [_block_tree(layer)]},
                                device="cpu")["blocks"][0]


# --- blocks ---------------------------------------------------------------------

def test_layer_windows_match_jax():
    jcfg, cfg = _cfgs()
    for S in (5, 8, 30):
        assert hybrid.layer_windows(cfg, S) == \
            np.asarray(jax_hybrid.layer_windows(jcfg, S)).tolist()
    full = get_config(ARCH)
    w = hybrid.layer_windows(full, 2048)
    assert [i for i, x in enumerate(w) if x == 2048] == [0, 15, 31]
    assert set(w) == {1024, 2048}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer, window", [(0, 20), (1, 8), (1, 3)],
                         ids=["global", "local8", "local3"])
def test_apply_hymba_block_matches_jax(layer, window, dtype):
    """S = 20, chunks of 5 in the Mamba heads; a global window (the
    sequence) and local ones of 8 and 3."""
    jcfg, cfg = _cfgs(dtype)
    x = np.random.default_rng(layer).standard_normal(
        (B, 20, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_hybrid.apply_hymba_block(
        p, x, jcfg, window))(jax.tree.map(jnp.asarray, _block_tree(layer)),
                             jnp.asarray(x).astype(JNP[dtype]))
    got = hybrid.apply_hymba_block(_block_params(layer),
                                   torch.from_numpy(x).to(TORCH[dtype]), cfg,
                                   window)
    assert got.shape == x.shape and got.dtype == TORCH[dtype]
    assert _rel_err(_np(got), _np(want)) < {"float32": 1e-5,
                                             "bfloat16": 3e-2}[dtype]


def test_the_window_changes_the_block():
    """The local window is live: a window of 3 and the global one give
    different outputs on the same input (the check above is not vacuous)."""
    _, cfg = _cfgs()
    p = _block_params(1)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, 20, cfg.d_model)).astype(np.float32))
    assert not torch.allclose(hybrid.apply_hymba_block(p, x, cfg, 3),
                              hybrid.apply_hymba_block(p, x, cfg, 20))


# --- the model ------------------------------------------------------------------

def test_init_lm_has_the_reference_structure():
    jcfg, cfg = _cfgs()
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    want = jax.tree.map(lambda s: s.shape[1:], shapes["blocks"])
    assert len(params["blocks"]) == cfg.n_layers
    for blk in params["blocks"]:
        assert jax.tree.map(lambda t: tuple(t.shape), blk) == want
    assert tuple(params["lm_head"].shape) == (cfg.d_model, cfg.vocab_size)
    assert "pos_embed" not in params
    assert common.count_params(params) == \
        jax.tree_util.tree_reduce(lambda n, s: n + s.size, shapes, 0)


def test_scanned_hymba_leaves_unstack_into_the_layer_list():
    """Every stacked leaf (the Mamba heads' and the fusion's among them)
    becomes its layer's tensor; the listed layout gives the same."""
    tree = _tree()
    stacked = lm_params_from_numpy(tree, device="cpu")
    listed = lm_params_from_numpy(dict(tree, blocks=[
        _block_tree(i) for i in range(3)]), device="cpu")
    for i in range(3):
        blk = stacked["blocks"][i]
        assert torch.equal(blk["mamba"]["D_skip"], torch.from_numpy(
            tree["blocks"]["mamba"]["D_skip"][i]))
        assert torch.equal(blk["beta_attn"], torch.from_numpy(
            tree["blocks"]["beta_attn"][i]))
        for a, b in zip(jax.tree.leaves(blk), jax.tree.leaves(
                listed["blocks"][i])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype, kmm", [("float32", False), ("float32", True),
                                        ("bfloat16", True)],
                         ids=["f32", "f32-kernel-matmul", "bf16-kernel-matmul"])
def test_forward_matches_jax(dtype, kmm):
    """S = 24 (past the window of 8; chunks of 8).  ``use_kernel_matmul``
    routes the FFN products through ``ops.matmul``, its plain version on the
    CPU, as the reference's ``use_pallas_matmul`` does not; the reference
    runs its plain path."""
    jcfg, cfg = _cfgs(dtype)
    cfg = cfg.replace(use_kernel_matmul=kmm)
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
    """Global layers hold MAX_LEN rows, the local one a ring of the window;
    every leaf zero, its own tensor, in the reference's dtype."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype)
        cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
        want = jax_tf.init_cache(jcfg, B, MAX_LEN)
        assert set(cache) == set(want) == {"layer0", "layer1", "layer2"}
        for name, row in cache.items():
            for k, t in row.items():
                assert t.shape == want[name][k].shape, (name, k)
                assert _np(t).dtype == np.float32 and not t.any()
                assert t.dtype == (TORCH[dtype] if k in "kv"
                                   else torch.float32)
        assert [cache[f"layer{i}"]["k"].shape[1] for i in range(3)] == \
            [MAX_LEN, 8, MAX_LEN]
        ptrs = [t.data_ptr() for row in cache.values() for t in row.values()]
        assert len(set(ptrs)) == len(ptrs)
    assert transformer.init_cache(cfg, B, 5, device="cpu")["layer1"][
        "k"].shape[1] == 5                               # min(window, max_len)


@functools.lru_cache(maxsize=None)
def _jax_decode(dtype="float32"):
    """JAX's decode over every position: its cache after ``PREFIX`` tokens
    and after each step, and each step's logits."""
    jcfg, _ = _cfgs(dtype)
    params = jax.tree.map(jnp.asarray, _tree())
    step = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(p, t, c, pos, jcfg))
    toks = _tokens(jcfg.vocab_size, (B, MAX_LEN), 2)
    cache = jax_tf.init_cache(jcfg, B, MAX_LEN)
    logits, caches, prefix_cache = [], [], None
    for t in range(MAX_LEN):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax_past_the_ring(dtype):
    """From pos 0 through 13: the local layer's ring of 8 wraps at pos 8.
    Each step's logits and the whole cache after it (the ring's rows, the
    global buffers, the Mamba states) against the reference's; bf16 within
    the forward's 5e-2."""
    tol = {"float32": 1e-5, "bfloat16": 5e-2}[dtype]
    _, want_logits, want_caches = _jax_decode(dtype)
    _, cfg = _cfgs(dtype)
    params = lm_params_from_numpy(_tree(), device="cpu")
    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, MAX_LEN), 2)).long()
    for t in range(MAX_LEN):
        logits, out = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                              t, cfg)
        assert out is cache and logits.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(logits), want_logits[t]) < tol, t
        _assert_cache_close(cache, want_caches[t], tol)


def test_decode_continues_from_a_jax_cache():
    """The reference's cache after 10 tokens (the ring wrapped twice over
    its first slots) carried across by ``cache_from_numpy``; the port goes
    on decoding from it."""
    prefix_cache, want_logits, want_caches = _jax_decode()
    _, cfg = _cfgs()
    params = lm_params_from_numpy(_tree(), device="cpu")
    cache = cache_from_numpy(prefix_cache, device="cpu")
    for name, row in prefix_cache.items():
        for k, w in row.items():
            np.testing.assert_array_equal(_np(cache[name][k]), w)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, MAX_LEN), 2)).long()
    for t in range(PREFIX, MAX_LEN):
        logits, cache = transformer.decode_step(params, toks[:, t:t + 1],
                                                cache, t, cfg)
        assert _rel_err(_np(logits), want_logits[t]) < 1e-5, t
    _assert_cache_close(cache, want_caches[-1])


def test_decode_writes_the_ring_in_place():
    """The token at pos lands in its ring slot pos % 8 of the same buffer;
    the global layers write row pos."""
    _, cfg = _cfgs()
    params = lm_params_from_numpy(_tree(), device="cpu")
    cache = transformer.init_cache(cfg, B, MAX_LEN, device="cpu")
    bufs = {i: cache[f"layer{i}"]["k"] for i in range(3)}
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, MAX_LEN), 2)).long()
    for t in range(10):
        before = cache["layer1"]["k"].clone()
        transformer.decode_step(params, toks[:, t:t + 1], cache, t, cfg)
        ring = cache["layer1"]["k"]
        assert ring is bufs[1] and cache["layer0"]["k"] is bufs[0]
        changed = (ring != before).any(-1).any(-1).any(0).nonzero().ravel()
        assert changed.tolist() == [t % 8]
        assert cache["layer0"]["k"][:, t].any() and \
            not cache["layer0"]["k"][:, t + 1:].any()


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
    """A prompt of 4 and 8 new tokens: the window of 8 wraps."""
    jcfg, cfg = _cfgs()
    prompt = _tokens(cfg.vocab_size, (B, 4), 4)
    want = jax_engine.greedy_generate(jax.tree.map(jnp.asarray, _tree()), jcfg,
                                      jnp.asarray(prompt), steps=8,
                                      max_len=12)
    got = engine.greedy_generate(lm_params_from_numpy(_tree(), device="cpu"),
                                 cfg, torch.from_numpy(prompt).long(),
                                 steps=8, max_len=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_generates_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3",
                           "--new-tokens", "9", "--seed", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(re.escape(ARCH) + r": batch=2 \+9 tokens in "
                        r"[0-9.]+s \([0-9]+ tok/s\)", out[0])
    seq = json.loads(out[1].removeprefix("first sequence: "))
    assert len(seq) == 12 and all(0 <= t < 512 for t in seq)

