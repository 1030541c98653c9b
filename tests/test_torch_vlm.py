"""The port's VLM family (``models/vlm.py``: the connector, the prefixed
forward, decode on the language model), its serving, CLI and train loss,
on the CPU, against the JAX package's.

internvl2-26b at its reduced size: 2 layers, d 64, GQA 4/2 at dh 16, d_ff
160, vocab 512, untied head, 4 visual tokens of width 32.  Weights are
numpy draws in the reference's scanned layout (norm scales and the
connector's biases moved off their init), carried across by
``convert.vlm_params_from_numpy``; patches and tokens are seeded numpy.
The reference runs its plain path; the port's ``use_flash`` /
``use_kernel_matmul`` take the kernels' plain versions on the CPU.

Tolerances, rel error = max|got - want| / max|want|, fp32: 1e-5 for the
forward and every decode step's logits and the cache (the same products in
other summation orders); tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import vlm as jax_vlm
from repro.serve import engine as jax_engine
from repro.train import loop as jax_loop
from repro_torch.configs import get_reduced
from repro_torch.convert import cache_from_numpy, vlm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common, vlm
from repro_torch.optim.optimizer import AdamW
from repro_torch.serve import engine
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

ARCH = "internvl2-26b"
TOL = 1e-5
B, S, MAX_LEN, PREFIX = 2, 12, 10, 4
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
    """The reference ``init_vlm`` tree's structure (the LM's blocks stacked
    on a layer axis), filled from numpy."""
    jcfg, _ = _cfgs()
    shapes = jax.eval_shape(lambda: jax_vlm.init_vlm(jax.random.PRNGKey(0),
                                                     jcfg))
    rng = np.random.default_rng(0)

    def fill(path, s):
        leaf = str(path[-1].key)
        n = rng.standard_normal(s.shape)
        if leaf == "scale":
            x = 1.0 + 0.1 * n
        elif leaf == "embed":
            x = 0.02 * n
        elif leaf in ("b1", "b2"):
            x = 0.1 * n
        else:                                 # (…, d_in, d_out) weights
            x = n / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jparams():
    return jax.tree.map(jnp.asarray, _tree())


def _params():
    return vlm_params_from_numpy(_tree(), device="cpu")


def _patches(seed=1):
    _, cfg = _cfgs()
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.visual_tokens, cfg.visual_width)).astype(np.float32)


def _tokens(n, seed=2):
    _, cfg = _cfgs()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_init_vlm_has_the_reference_structure():
    jcfg, cfg = _cfgs()
    params = vlm.init_vlm(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: jax_vlm.init_vlm(jax.random.PRNGKey(0),
                                                     jcfg))
    want = jax.tree.map(lambda s: s.shape[1:], shapes["lm"]["blocks"])
    assert len(params["lm"]["blocks"]) == cfg.n_layers
    for blk in params["lm"]["blocks"]:
        assert jax.tree.map(lambda t: tuple(t.shape), blk) == want
    assert jax.tree.map(lambda t: tuple(t.shape), params["connector"]) == \
        jax.tree.map(lambda s: s.shape, shapes["connector"])
    assert common.count_params(params) == \
        jax.tree_util.tree_reduce(lambda n, s: n + s.size, shapes, 0)


@functools.lru_cache(maxsize=None)
def _jax_forward():
    jcfg, _ = _cfgs()
    logits, aux = jax.jit(lambda p, t, x: jax_vlm.forward(p, t, x, jcfg))(
        _jparams(), jnp.asarray(_tokens(S)), jnp.asarray(_patches()))
    vis = jax.jit(lambda p, x: jax_vlm._project_visual(p, x, jcfg))(
        _jparams(), jnp.asarray(_patches()))
    return _np(logits), float(aux), _np(vis)


@pytest.mark.parametrize("flash, kmm", FLAGS, ids=FLAG_IDS)
def test_forward_matches_jax(flash, kmm):
    """The visual tokens first, then the text, causal over the joined
    sequence (RoPE positions 0 … N_vis + S - 1)."""
    _, cfg = _cfgs(use_flash=flash, use_kernel_matmul=kmm)
    want, want_aux, _ = _jax_forward()
    logits, aux = vlm.forward(_params(), torch.from_numpy(_tokens(S)).long(),
                              torch.from_numpy(_patches()), cfg)
    assert logits.shape == (B, cfg.visual_tokens + S, cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) == want_aux == 0.0
    assert _rel_err(_np(logits), want) < TOL


def test_project_visual_matches_jax():
    """The bias is added before the tanh-form GELU."""
    _, cfg = _cfgs()
    got = vlm._project_visual(_params(), torch.from_numpy(_patches()), cfg)
    assert got.shape == (B, cfg.visual_tokens, cfg.d_model)
    assert _rel_err(_np(got), _jax_forward()[2]) < TOL


def test_the_text_sees_the_visual_prefix():
    """A change in the patches moves the text's logits; the visual rows do
    not see the text (a change in the last token leaves them)."""
    _, cfg = _cfgs()
    params = _params()
    toks = torch.from_numpy(_tokens(S)).long()
    patches = torch.from_numpy(_patches())
    base, _ = vlm.forward(params, toks, patches, cfg)
    moved, _ = vlm.forward(params, toks, patches + 1.0, cfg)
    nv = cfg.visual_tokens
    assert not torch.allclose(base[:, nv:], moved[:, nv:])
    other = toks.clone()
    other[:, -1] = (other[:, -1] + 1) % cfg.vocab_size
    again, _ = vlm.forward(params, other, patches, cfg)
    assert torch.equal(base[:, :nv], again[:, :nv])


# --- decode and serving ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode():
    """The reference's VLM decode from pos 0, text only: the cache after
    ``PREFIX`` tokens, each step's logits and the final cache."""
    jcfg, _ = _cfgs()
    params = _jparams()
    step = jax.jit(lambda p, t, c, pos: jax_vlm.decode_step(p, t, c, pos,
                                                            jcfg))
    toks = _tokens(MAX_LEN, seed=3)
    cache = jax_vlm.init_cache(jcfg, B, MAX_LEN)
    logits, prefix = [], None
    for t in range(MAX_LEN):
        if t == PREFIX:
            prefix = jax.tree.map(np.asarray, cache)
        lg, cache = step(params, jnp.asarray(toks[:, t:t + 1]), cache,
                         jnp.int32(t))
        logits.append(_np(lg))
    return prefix, logits, jax.tree.map(np.asarray, cache)


@pytest.mark.parametrize("kmm", [False, True], ids=["plain",
                                                     "use_kernel_matmul"])
def test_decode_from_pos_0_matches_jax(kmm):
    """Decode is the dense path on ``params["lm"]`` from pos 0: the visual
    prefix is never in the cache, as in the reference."""
    _, want_logits, want_cache = _jax_decode()
    _, cfg = _cfgs(use_flash=True, use_kernel_matmul=kmm)
    params = _params()
    cache = vlm.init_cache(cfg, B, MAX_LEN, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads,
                                cfg.dh)
    toks = torch.from_numpy(_tokens(MAX_LEN, seed=3)).long()
    for t in range(MAX_LEN):
        logits, out = vlm.decode_step(params, toks[:, t:t + 1], cache, t, cfg)
        assert out is cache and logits.shape == (B, 1, cfg.vocab_size)
        assert _rel_err(_np(logits), want_logits[t]) < TOL, t
    for name in ("k", "v"):
        assert _rel_err(_np(cache[name]), want_cache[name]) < TOL


def test_decode_from_a_jax_filled_cache():
    prefix, want_logits, _ = _jax_decode()
    _, cfg = _cfgs()
    params = _params()
    cache = cache_from_numpy(prefix, device="cpu")
    toks = torch.from_numpy(_tokens(MAX_LEN, seed=3)).long()
    for t in range(PREFIX, MAX_LEN):
        logits, _ = vlm.decode_step(params, toks[:, t:t + 1], cache, t, cfg)
        assert _rel_err(_np(logits), want_logits[t]) < TOL, t


def test_greedy_generate_matches_jax_token_for_token():
    jcfg, cfg = _cfgs(use_flash=True, use_kernel_matmul=True)
    prompt = _tokens(4, seed=5)
    want = jax_engine.greedy_generate(_jparams(), jcfg, jnp.asarray(prompt),
                                      steps=6, max_len=10)
    got = engine.greedy_generate(_params(), cfg,
                                 torch.from_numpy(prompt).long(), steps=6,
                                 max_len=10)
    assert got.shape == (B, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_serves_on_the_language_model_path(capsys):
    """``--arch internvl2-26b --reduced`` serves text only, as the
    reference's CLI does."""
    assert serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "3",
                           "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "internvl2-26b: batch=2 +4 tokens" in out
    first = out.split("first sequence:")[1].strip()
    assert len(first.strip("[]").split(",")) == 3 + 4


# --- the train loss ---------------------------------------------------------------

def test_vlm_loss_and_grads_match_jax():
    """``make_loss_fn``'s VLM loss (CE over the text positions only) and its
    grads against ``jax.value_and_grad`` of the reference's: each grad
    within 1e-5 of its own largest value."""
    jcfg, cfg = _cfgs()
    toks = _tokens(S + 1, seed=7)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": _patches(seed=8)}
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
    want = tree_leaves(vlm_params_from_numpy(
        jax.tree.map(np.asarray, jgrads), device="cpu"))
    for g, w in zip(grads, want, strict=True):
        assert g.shape == w.shape
        assert _rel_err(_np(g), _np(w)) < TOL
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  AdamW(), device="cpu")
    assert set(state.params) == {"lm", "connector"}
