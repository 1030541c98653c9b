"""The port's decode (KV cache, ``decode_step``) and chunked attention on the
CPU, against the JAX package's.

Weights are numpy draws at ``dense_init`` / ``embed_init`` scales, with the
norm scales, biases and QK-norm scales moved away from their init, in the
reference's scanned layout; the port takes them through
``convert.lm_params_from_numpy``.  The JAX package fills the first tokens'
cache, which the port takes over through ``convert.cache_from_numpy``;
then both decode the same tokens.  No Pallas kernel is on the reference's
decode path (it routes to flash only when the query and key lengths agree).

Tolerances, rel error = max|got - want| / max|want| over each step's logits
and over the final cache:
  * fp32: 1e-5 (the same products in another summation order).
  * bf16: 2e-2 (one bf16 rounding of a product, carried through 2-3
    residual layers).
Decode against the port's own forward, teacher-forced: the reference's own
test's bounds (``tests/test_serve.py``: atol 2e-4, rtol 1e-3, fp32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import attention as jax_attn
from repro.models import transformer as jax_tf
from repro_torch.configs import get_reduced
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.models import attention, transformer

B, MAX_LEN, PREFIX = 2, 8, 3
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: (arch, changes): GQA G = 1 and 2, qkv bias, relu2 with layernorm through
#: the kernel path's plain version, a window shorter than the run, QK-norm,
#: learned positions
CASES = {
    "smollm": ("smollm-135m", {}),
    "qwen2.5_gqa_bias": ("qwen2.5-3b", {}),
    "minitron_kernel_path": ("minitron-8b", {"kernel": True}),
    "smollm_window4": ("smollm-135m", {"sliding_window": 4}),
    "smollm_qk_norm": ("smollm-135m", {"qk_norm": True}),
    "smollm_learned_pos": ("smollm-135m", {"pos_emb": "learned"}),
}
PARITY = [(c, "float32") for c in CASES] + [
    ("smollm", "bfloat16"), ("qwen2.5_gqa_bias", "bfloat16")]


def _cfgs(case, dtype):
    arch, kw = CASES[case]
    kw = dict(kw)
    kernel = kw.pop("kernel", False)
    return (jax_get_reduced(arch).replace(compute_dtype=JNP[dtype],
                                          use_pallas_matmul=kernel, **kw),
            get_reduced(arch).replace(compute_dtype=TORCH[dtype],
                                      use_kernel_matmul=kernel, **kw))


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))),
                                                   1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _tree(case):
    """The reference ``init_lm`` tree's structure, filled from numpy."""
    jcfg, _ = _cfgs(case, "float32")
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape)
        if "scale" in name or "_norm']" in name:
            x = 1.0 + 0.1 * n
        elif "embed" in name:
            x = 0.02 * n
        elif len(s.shape) == 1 or "bias" in name or "['b" in name:
            x = 0.1 * n                        # biases: (…, d_out)
        else:                                  # (…, d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tokens(vocab, n=MAX_LEN, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(case, dtype):
    """JAX's decode over every position: the cache after ``PREFIX`` tokens,
    each later step's logits, and the final cache."""
    jcfg, _ = _cfgs(case, dtype)
    params = jax.tree.map(jnp.asarray, _tree(case))
    step = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(p, t, c, pos, jcfg))
    toks = _tokens(jcfg.vocab_size)
    cache = jax_tf.init_cache(jcfg, B, MAX_LEN)
    logits, prefix_cache = [], None
    for t in range(MAX_LEN):
        if t == PREFIX:
            prefix_cache = jax.tree.map(np.asarray, cache)
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        if t >= PREFIX:
            logits.append(_np(lg))
    return prefix_cache, logits, jax.tree.map(_np, cache)


@pytest.mark.parametrize("case, dtype", PARITY, ids=[f"{c}-{d}"
                                                      for c, d in PARITY])
def test_decode_step_matches_jax_per_token(case, dtype):
    prefix_cache, want_logits, want_cache = _jax_run(case, dtype)
    _, cfg = _cfgs(case, dtype)
    params = lm_params_from_numpy(_tree(case), device="cpu")
    cache = cache_from_numpy(prefix_cache, device="cpu")
    assert cache["k"].dtype == TORCH[dtype]
    assert cache["k"].shape == (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads,
                                cfg.dh)
    toks = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    for t, want in zip(range(PREFIX, MAX_LEN), want_logits):
        logits, out = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                              t, cfg)
        assert out is cache                       # updated in place
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert logits.dtype == TORCH[dtype]
        assert _rel_err(_np(logits), want) < TOL[dtype], t
    for name in ("k", "v"):
        assert _rel_err(_np(cache[name]), want_cache[name]) < TOL[dtype]


def test_learned_position_past_the_table_is_clamped_as_in_jax():
    """Learned positions with ``max_seq_len`` 8 and a 12-row cache: the
    steps at pos 8 … 11 read the table's last row, as the reference's
    ``dynamic_slice_in_dim`` clamps it, and the logits match its to 1e-5."""
    case, n = "smollm_learned_pos", 12
    jcfg, cfg = _cfgs(case, "float32")
    jcfg, cfg = jcfg.replace(max_seq_len=8), cfg.replace(max_seq_len=8)
    tree = dict(_tree(case))
    tree["pos_embed"] = tree["pos_embed"][:8]
    step = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(p, t, c, pos, jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jax_tf.init_cache(jcfg, B, n)
    params = lm_params_from_numpy(tree, device="cpu")
    cache = transformer.init_cache(cfg, B, n, device="cpu")
    toks = _tokens(cfg.vocab_size, n=n, seed=3)
    for t in range(n):
        want, jcache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jcache,
                            jnp.int32(t))
        got, _ = transformer.decode_step(
            params, torch.from_numpy(toks[:, t:t + 1]).long(), cache, t, cfg)
        assert got.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(got), _np(want)) < TOL["float32"], t
    for name in ("k", "v"):
        assert _rel_err(_np(cache[name]), _np(jcache[name])) < TOL["float32"]


def _teacher_forced(cfg, params, toks):
    cache = transformer.init_cache(cfg, B, toks.shape[1], device="cpu")
    rows = [transformer.decode_step(params, toks[:, t:t + 1], cache, t,
                                    cfg)[0][:, 0]
            for t in range(toks.shape[1])]
    return torch.stack(rows, dim=1)


def _check_against_forward(case):
    _, cfg = _cfgs(case, "float32")
    params = lm_params_from_numpy(_tree(case), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, n=12, seed=2)).long()
    full, _ = transformer.forward(params, toks, cfg)
    np.testing.assert_allclose(_np(_teacher_forced(cfg, params, toks)),
                               _np(full), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_matches_the_ports_forward(case):
    _check_against_forward(case)


def test_a_decode_mask_off_by_one_fails_the_check(monkeypatch):
    """The planted fault: each token sees the keys before it but not its
    own (``kpos < pos``); the teacher-forced check must catch it."""
    def off_by_one(s_max, pos, window, device):
        kpos = torch.arange(s_max, device=device)
        return torch.where(kpos < pos, 0.0, attention.NEG_INF).float()[None, :]

    monkeypatch.setattr(attention, "_decode_bias", off_by_one)
    with pytest.raises(AssertionError):
        _check_against_forward("smollm")


def test_decode_bias_is_the_references_mask():
    for pos, window in ((0, 0), (5, 0), (5, 3), (7, 8)):
        got = attention._decode_bias(9, pos, window, torch.device("cpu"))
        kpos = np.arange(9)
        ok = (kpos <= pos) & ((kpos > pos - window) if window > 0 else True)
        want = np.where(ok, 0.0, float(jax_attn.NEG_INF))[None, :]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_cache_layout_and_device():
    _, cfg = _cfgs("qwen2.5_gqa_bias", "bfloat16")
    jcfg, _ = _cfgs("qwen2.5_gqa_bias", "bfloat16")
    cache = transformer.init_cache(cfg, 3, 5, device="cpu")
    want = jax_attn.init_kv_cache(jcfg, 3, 5)
    for name in ("k", "v"):
        assert cache[name].shape == want[name].shape
        assert cache[name].dtype == torch.bfloat16
        assert not cache[name].any()
    if torch.cuda.is_available():
        return                            # None resolves to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 3, 5)
    with pytest.raises(ValueError, match="models/encdec.py"):
        transformer.init_cache(cfg.replace(family="encdec"), 3, 5,
                               device="cpu")


# --- chunked attention --------------------------------------------------------

CHUNKED = [(True, 0), (True, 8), (False, 0)]


@pytest.mark.parametrize("causal, window", CHUNKED,
                         ids=["causal", "causal_window8", "bidirectional"])
def test_blockwise_sdpa_matches_jax(causal, window):
    """S = 40 in q blocks of 16: two whole blocks and a ragged one, GQA
    G = 2, fp32."""
    jcfg, cfg = _cfgs("qwen2.5_gqa_bias", "float32")
    jcfg = jcfg.replace(attn_impl="chunked", attn_block_q=16)
    cfg = cfg.replace(attn_impl="chunked", attn_block_q=16)
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 40, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    want = jax_attn._blockwise_sdpa(*map(jnp.asarray, (q, k, v)), jcfg,
                                    causal, window)
    got = attention._blockwise_sdpa(*map(torch.from_numpy, (q, k, v)), cfg,
                                    causal, window)
    assert got.shape == (2, 40, 4, 16)
    assert _rel_err(_np(got), _np(want)) < 1e-5
    dense = attention._sdpa(*map(torch.from_numpy, (q, k, v)),
                            attention._mask_bias(40, 40, causal, window), cfg)
    assert _rel_err(_np(got), _np(dense)) < 1e-5


def test_chunked_forward_matches_jax():
    """``attn_impl="chunked"`` through the whole forward (S = 40 > the
    block of 16)."""
    jcfg, cfg = _cfgs("smollm", "float32")
    jcfg = jcfg.replace(attn_impl="chunked", attn_block_q=16)
    cfg = cfg.replace(attn_impl="chunked", attn_block_q=16)
    toks = _tokens(cfg.vocab_size, n=40, seed=4)
    want, _ = jax_tf.forward(jax.tree.map(jnp.asarray, _tree("smollm")),
                             jnp.asarray(toks), jcfg)
    got, _ = transformer.forward(lm_params_from_numpy(_tree("smollm"),
                                                      device="cpu"),
                                 torch.from_numpy(toks).long(), cfg)
    assert _rel_err(_np(got), _np(want)) < 1e-5
