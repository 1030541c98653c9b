"""The port's MoE (``models/moe.py``) and the moe family in forward, decode
and serving, on the CPU, against the JAX package's.

Both MoE configs at their reduced sizes: qwen2-moe-a2.7b (2 layers, d 64,
MHA 4/4, 8 experts top-2, 1 shared expert, QKV bias) and qwen3-moe-30b-a3b
(2 layers, d 64, GQA 4/2, dh 16, QK-norm, 8 experts top-2, no shared).
Weights are numpy draws in the reference's scanned layout (norm scales,
biases and QK-norm scales moved off their init), carried across by
``convert.lm_params_from_numpy``; inputs are seeded numpy.

Tolerances, rel error = max|got - want| / max|want|:
  * ``route`` in fp32: 1e-6 (one softmax, a gather and a division on
    equal inputs); the expert indices exactly equal.
  * ``apply_moe`` in fp32: 1e-5 (the same products in another summation
    order, over the same dispatch: the choices and slots are equal).
  * ``apply_moe`` in bf16: 3e-2, on inputs where both sides chose the same
    experts (asserted first): each side rounds each einsum's output to bf16
    and the gates before the combine, in other orders.
  * the whole forward in fp32 with ``use_flash``: 1e-4 (the bound of
    ``tests/test_torch_transformer.py``), logits and aux.
  * ``decode_step`` from a cache the JAX package filled: 1e-5 in fp32 (as
    ``tests/test_torch_decode.py``).
  * decode against the port's forward with no choice dropped: the
    reference's own bounds (``tests/test_serve.py``: atol 2e-4, rtol 1e-3).
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
from repro.distributed import collectives as jax_coll
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.distributed import collectives
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common, moe, transformer
from repro_torch.serve import engine

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-30b-a3b")
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: decode: B sequences, a cache of MAX_LEN, the JAX package fills PREFIX
B, MAX_LEN, PREFIX = 2, 8, 3


def _cfgs(arch, dtype="float32", **kw):
    return (jax_get_reduced(arch).replace(compute_dtype=JNP[dtype], **kw),
            get_reduced(arch).replace(compute_dtype=TORCH[dtype], **kw))


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
def _tree(arch, pad_experts_to=0):
    """The reference ``init_lm`` tree's structure, filled from numpy."""
    jcfg, _ = _cfgs(arch, pad_experts_to=pad_experts_to)
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape)
        if "scale" in name or "_norm']" in name:
            x = 1.0 + 0.1 * n
        elif "embed" in name:
            x = 0.02 * n
        elif len(s.shape) <= 2 and "router" not in name:
            x = 0.1 * n                        # biases: (L, d_out)
        else:                                  # (…, d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _moe_tree(arch, layer=0, pad_experts_to=0):
    """One layer's ``moe`` subtree, as numpy."""
    return jax.tree.map(lambda a: np.asarray(a[layer]),
                        _tree(arch, pad_experts_to)["blocks"]["moe"])


def _moe_params(tree):
    return lm_params_from_numpy({"blocks": [tree]}, device="cpu")["blocks"][0]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# --- routing and capacity ----------------------------------------------------------

@pytest.mark.parametrize("E, k", [(8, 2), (60, 4), (128, 8)])
def test_route_matches_jax(E, k):
    jcfg, cfg = _cfgs(ARCHS[0], n_experts=E, moe_top_k=k)
    logits = _x((300, E), E + k)
    jg, ji, jaux = jax_moe.route(jnp.asarray(logits), jcfg)
    g, i, aux = moe.route(torch.from_numpy(logits), cfg)
    assert g.dtype == aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert _rel_err(_np(g), _np(jg)) < 1e-6
    assert abs(float(aux) - float(jaux)) < 1e-6 * abs(float(jaux))


def test_route_breaks_ties_to_the_lower_index():
    """Equal logits give exactly equal probs; ``lax.top_k`` puts the lower
    expert index first, and so must the port (bf16 router logits tie in a
    few percent of rows at full width)."""
    jcfg, cfg = _cfgs(ARCHS[0], n_experts=8, moe_top_k=2)
    logits = np.array([[0.0, 3.0, 3.0, 3.0, 1.0, 0.0, 0.0, 0.0],
                       [2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 2.0],
                       [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                       [0.0, 0.0, 5.0, 0.0, 0.0, 4.0, 0.0, 4.0]], np.float32)
    _, ji, _ = jax_moe.route(jnp.asarray(logits), jcfg)
    g, i, _ = moe.route(torch.from_numpy(logits), cfg)
    want = [[1, 2], [0, 7], [0, 1], [2, 5]]
    assert np.asarray(ji).tolist() == want
    assert i.tolist() == want
    np.testing.assert_array_equal(g[:3].numpy(), np.full((3, 2), 0.5,
                                                         np.float32))


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 15.0])
def test_capacity_matches_jax(cf):
    for tokens in (1, 2, 8, 100, 512, 2048):
        for E, k in ((8, 2), (60, 4), (128, 8)):
            jcfg, cfg = _cfgs(ARCHS[0], n_experts=E, moe_top_k=k,
                              capacity_factor=cf)
            assert moe._capacity(tokens, cfg) == jax_moe._capacity(tokens, jcfg)
    _, cfg = _cfgs(ARCHS[0], n_experts=60, moe_top_k=4)
    assert moe._capacity(2048, cfg) == 170 and moe._capacity(8, cfg) == 4


# --- apply_moe ----------------------------------------------------------------------

def _dropped(cfg, params, x):
    """How many (token, choice) pairs overflow their expert's buffer, by the
    port's own routing of one group of all of ``x``'s tokens."""
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx, _ = moe.route(xt @ params["router"], cfg)
    C = moe._capacity(xt.shape[0], cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int((counts - C).clamp_min(0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pad", [0, 12])
def test_apply_moe_fp32_matches_jax_with_drops(arch, pad):
    """A capacity factor of 0.5 drops choices (asserted); with 12 padded
    experts the dead ones take no token."""
    jcfg, cfg = _cfgs(arch, capacity_factor=0.5, pad_experts_to=pad)
    tree = _moe_tree(arch, pad_experts_to=pad)
    x = _x((2, 40, cfg.d_model), 7)
    params = _moe_params(tree)
    if pad:
        assert params["w_gate"].shape[0] == pad
        assert params["router"].shape[1] == cfg.n_experts
    assert _dropped(cfg, params, x) > 0
    want, jaux = jax_moe.apply_moe(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(x), jcfg)
    got, aux = moe.apply_moe(params, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert _rel_err(_np(got), _np(want)) < 1e-5
    assert abs(float(aux) - float(jaux)) < 1e-5 * abs(float(jaux))


def test_dead_padded_experts_contribute_nothing():
    """A token routed to a padding expert would make the output depend on
    its weights: scaling them by 100 (or leaving them out) must change
    nothing, bit for bit."""
    arch = ARCHS[0]
    _, cfg = _cfgs(arch, pad_experts_to=12)
    params = _moe_params(_moe_tree(arch, pad_experts_to=12))
    x = torch.from_numpy(_x((2, 40, cfg.d_model), 8))
    base, _ = moe.apply_moe(params, x, cfg)
    loud = {n: w.clone() for n, w in params.items() if n.startswith("w_")}
    for w in loud.values():
        w[cfg.n_experts:] *= 100.0
    got, _ = moe.apply_moe({**params, **loud}, x, cfg)
    assert torch.equal(got, base)
    cut = {**params, **{n: params[n][:cfg.n_experts] for n in loud}}
    got, _ = moe.apply_moe(cut, x, cfg)
    assert torch.equal(got, base)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_bf16_matches_jax_on_the_same_experts(arch):
    jcfg, cfg = _cfgs(arch, "bfloat16")
    tree = _moe_tree(arch, layer=1)
    x = _x((2, 48, cfg.d_model), 9)
    jt = jax.tree.map(jnp.asarray, tree)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    params = _moe_params(tree)
    jlogits = jnp.einsum("td,de->te", jx.reshape(-1, cfg.d_model),
                         jt["router"].astype(jnp.bfloat16))
    tlogits = tx.reshape(-1, cfg.d_model) @ params["router"].to(torch.bfloat16)
    _, ji, _ = jax_moe.route(jlogits, jcfg)
    _, ti, _ = moe.route(tlogits, cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    want, _ = jax_moe.apply_moe(jt, jx, jcfg)
    got, aux = moe.apply_moe(params, tx, cfg)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert _rel_err(_np(got), _np(want)) < 3e-2


# --- the model ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_with_flash(arch):
    """B = 2, S = 256: JAX's ``ops.flash_attention`` takes its Pallas kernel
    (interpret mode) from S = 256; one dispatch group of 512 tokens."""
    jcfg, cfg = _cfgs(arch, use_flash=True)
    tree = _tree(arch)
    toks = _tokens(cfg.vocab_size, (2, 256), 1)
    want, jaux = jax_tf.forward(jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(toks), jcfg)
    got, aux = transformer.forward(lm_params_from_numpy(tree, device="cpu"),
                                   torch.from_numpy(toks), cfg)
    assert got.shape == (2, 256, cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert _rel_err(_np(got), _np(want)) < 1e-4
    assert abs(float(aux) - float(jaux)) < 1e-4 * float(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_reference_structure(arch):
    jcfg, cfg = _cfgs(arch, pad_experts_to=10)
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    want = jax.tree.map(lambda s: s.shape[1:], shapes["blocks"])
    for blk in params["blocks"]:
        assert jax.tree.map(lambda t: tuple(t.shape), blk) == want
    assert common.count_params(params) == \
        jax.tree_util.tree_reduce(lambda n, s: n + s.size, shapes, 0)
    assert ("shared" in params["blocks"][0]["moe"]) == (arch == ARCHS[0])


def test_scanned_moe_leaves_unstack_into_the_layer_list():
    """(L, E, D, F) expert leaves, the router and the shared subtree: the
    stacked and the listed layouts give the same per-layer tensors."""
    tree = _tree(ARCHS[0])
    stacked = lm_params_from_numpy(tree, device="cpu")
    listed = lm_params_from_numpy(dict(tree, blocks=[
        jax.tree.map(lambda a, i=i: a[i], tree["blocks"]) for i in range(2)]),
        device="cpu")
    _, cfg = _cfgs(ARCHS[0])
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    for i in range(2):
        m = stacked["blocks"][i]["moe"]
        assert m["w_gate"].shape == m["w_up"].shape == (E, D, Fe)
        assert m["w_down"].shape == (E, Fe, D)
        assert m["router"].shape == (D, E)
        assert m["shared"]["w_down"].shape == (Fe * cfg.n_shared_experts, D)
        assert torch.equal(m["w_down"], torch.from_numpy(
            tree["blocks"]["moe"]["w_down"][i]))
        assert torch.equal(m["shared"]["w_gate"], torch.from_numpy(
            tree["blocks"]["moe"]["shared"]["w_gate"][i]))
        for a, b in zip(jax.tree.leaves(m),
                        jax.tree.leaves(listed["blocks"][i]["moe"])):
            assert torch.equal(a, b)


# --- decode and serving -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    """JAX's decode over every position: the cache after ``PREFIX`` tokens
    and each later step's logits."""
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(jnp.asarray, _tree(arch))
    step = jax.jit(lambda p, t, c, pos: jax_tf.decode_step(p, t, c, pos, jcfg))
    toks = _tokens(jcfg.vocab_size, (B, MAX_LEN), 1)
    cache = jax_tf.init_cache(jcfg, B, MAX_LEN)
    logits, prefix_cache = [], None
    for t in range(MAX_LEN):
        if t == PREFIX:
            prefix_cache = jax.tree.map(np.asarray, cache)
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        if t >= PREFIX:
            logits.append(_np(lg))
    return prefix_cache, logits


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_per_token(arch):
    prefix_cache, want_logits = _jax_decode(arch)
    _, cfg = _cfgs(arch)
    params = lm_params_from_numpy(_tree(arch), device="cpu")
    cache = cache_from_numpy(prefix_cache, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, MAX_LEN), 1)).long()
    for t, want in zip(range(PREFIX, MAX_LEN), want_logits):
        logits, out = transformer.decode_step(params, toks[:, t:t + 1], cache,
                                              t, cfg)
        assert out is cache and logits.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(logits), want) < 1e-5, t


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_ports_forward_without_drops(arch):
    """With ``capacity_factor = E / k`` no group drops a choice (C is the
    group's token count), so decode's B-token groups and the forward's
    sequence groups route every token alike."""
    _, cfg = _cfgs(arch)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    params = lm_params_from_numpy(_tree(arch), device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, 10), 2)).long()
    full, _ = transformer.forward(params, toks, cfg)
    cache = engine.init_cache(params, cfg, B, 10)
    step = engine.build_serve_step(cfg)
    rows = [step(params, toks[:, t:t + 1], cache, t)[0][:, 0]
            for t in range(10)]
    np.testing.assert_allclose(_np(torch.stack(rows, 1)), _np(full),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _tree(arch)
    prompt = _tokens(cfg.vocab_size, (2, 4), 3)
    want = jax_engine.greedy_generate(jax.tree.map(jnp.asarray, tree), jcfg,
                                      jnp.asarray(prompt), steps=4, max_len=8)
    got = engine.greedy_generate(lm_params_from_numpy(tree, device="cpu"),
                                 cfg, torch.from_numpy(prompt).long(),
                                 steps=4, max_len=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_generates_on_the_cpu(arch, capsys):
    assert serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3",
                           "--new-tokens", "3", "--seed", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(re.escape(arch) + r": batch=2 \+3 tokens in "
                        r"[0-9.]+s \([0-9]+ tok/s\)", out[0])
    seq = json.loads(out[1].removeprefix("first sequence: "))
    assert len(seq) == 6 and all(0 <= t < 512 for t in seq)


# --- collectives ----------------------------------------------------------------------

def test_all_to_all_matches_the_reference():
    payload = np.array([0.0, 1.0, 4096.0, 3.5e9, 1e12])
    for n in (1, 2, 3, 4, 8, 60, 512, np.inf):
        for p in payload:
            got = collectives.all_to_all(p, n)
            want = jax_coll.all_to_all(p, n)
            assert float(got.wire_bytes) == float(want.wire_bytes)
            assert float(got.steps) == float(want.steps)
            rs, jrs = collectives.reduce_scatter(p, n), \
                jax_coll.reduce_scatter(p, n)
            assert (float(rs.wire_bytes), float(rs.steps)) == \
                (float(jrs.wire_bytes), float(jrs.steps))
    grid_n = np.array([[1.0], [4.0], [16.0]])
    got, want = (m.all_to_all(payload[None, :], grid_n)
                 for m in (collectives, jax_coll))
    np.testing.assert_array_equal(got.wire_bytes, want.wire_bytes)
    np.testing.assert_array_equal(got.steps, want.steps)
    assert float(collectives.all_to_all(1e9, 1).wire_bytes) == 0.0
