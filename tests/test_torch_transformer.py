"""The port's dense transformer on the CPU against the JAX package's.

A reduced smollm-135m with G = 3 (3 layers, d 192, 6 query heads, 2 kv
heads, dh 32) at B = 2, S = 300, so that JAX's ``ops.flash_attention``
really goes through its Pallas kernel (interpret mode, S >= 256).  The
weights are numpy draws at ``dense_init`` / ``embed_init`` scales, with the
norm scales moved away from 1, in the reference's scanned layout; the port
takes them through ``convert.lm_params_from_numpy``.

Tolerances, rel error = max|got - want| / max|want|:
  * fp32: 1e-4 (the kernel tests' bound); the forward measures ~2e-6.
  * bf16 forward: 5e-2.  The two sides round to bf16 at different places
    in attention: the JAX kernel casts the unnormalised p to bf16 before
    P.V, the port's CPU path (``ref_flash_attention``) normalises in fp32;
    each 0.4% rounding is carried through 3 residual layers (measured
    ~1.7e-2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import ffn as jax_ffn
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.models import attention, common, ffn, transformer

SMALL = dict(n_layers=3, d_model=192, n_heads=6, n_kv_heads=2, d_ff=512,
             vocab_size=1024)
B, S = 2, 300
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = np.maximum(np.max(np.abs(want)), 1e-6)
    return float(np.max(np.abs(got - want))) / denom


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _cfgs(dtype, **kw):
    return (jax_get_config("smollm-135m").replace(
                compute_dtype=JNP[dtype], **SMALL, **kw),
            get_config("smollm-135m").replace(
                compute_dtype=TORCH[dtype], **SMALL, **kw))


def _numpy_tree(cfg, seed):
    """The reference ``init_lm`` tree's structure, filled from numpy."""
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            x = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif "embed" in name:
            x = 0.02 * rng.standard_normal(s.shape)
        else:                                 # (…, d_in, d_out) weights
            x = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _case():
    jcfg, _ = _cfgs("float32", use_flash=True)
    tree = _numpy_tree(jcfg, 0)
    tokens = np.random.default_rng(1).integers(
        0, SMALL["vocab_size"], (B, S)).astype(np.int32)
    return tree, tokens


@functools.lru_cache(maxsize=None)
def _jax_logits(dtype):
    tree, tokens = _case()
    jcfg, _ = _cfgs(dtype, use_flash=True)
    logits, aux = jax_tf.forward(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(tokens), jcfg)
    return _np(logits), float(aux)


@functools.lru_cache(maxsize=None)
def _jax_vlm_logits():
    """The reference's ``transformer.forward`` of a VLM config (its dense
    path), fp32."""
    tree, tokens = _case()
    jcfg, _ = _cfgs("float32")
    jcfg = jcfg.replace(family="vlm")
    logits, _ = jax_tf.forward(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(tokens), jcfg)
    return _np(logits)


# --- the whole forward ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_with_flash(dtype):
    tree, tokens = _case()
    _, cfg = _cfgs(dtype, use_flash=True)
    params = lm_params_from_numpy(tree, device="cpu")
    before = flash_attention_bhsd.launches
    logits, aux = transformer.forward(params, torch.from_numpy(tokens), cfg)
    want, want_aux = _jax_logits(dtype)
    assert logits.shape == (B, S, SMALL["vocab_size"])
    assert logits.dtype == TORCH[dtype]
    assert aux.dtype == torch.float32 and float(aux) == want_aux == 0.0
    assert _rel_err(_np(logits), want) < TOL[dtype]
    assert flash_attention_bhsd.launches == before   # CPU: plain version


def test_flash_and_plain_paths_agree_in_fp32():
    tree, tokens = _case()
    _, cfg = _cfgs("float32", use_flash=True)
    params = lm_params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(tokens)
    flash, _ = transformer.forward(params, toks, cfg)
    plain, _ = transformer.forward(params, toks, cfg.replace(use_flash=False))
    assert _rel_err(_np(flash), _np(plain)) < TOL["float32"]


def test_stacked_and_list_layouts_give_the_same_params():
    tree, _ = _case()
    stacked = lm_params_from_numpy(tree, device="cpu")
    L = SMALL["n_layers"]
    as_list = dict(tree, blocks=[jax.tree.map(lambda a, i=i: a[i],
                                              tree["blocks"])
                                 for i in range(L)])
    listed = lm_params_from_numpy(as_list, device="cpu")
    assert len(stacked["blocks"]) == len(listed["blocks"]) == L
    assert stacked["blocks"][1]["attn"]["wq"].shape == (192, 192)
    assert stacked["blocks"][2]["ffn"]["w_down"].shape == (512, 192)
    for i in range(L):
        for a, b in zip(jax.tree.leaves(stacked["blocks"][i]),
                        jax.tree.leaves(listed["blocks"][i])):
            assert torch.equal(a, b)
    assert torch.equal(stacked["blocks"][2]["attn"]["wk"],
                       torch.from_numpy(tree["blocks"]["attn"]["wk"][2]))


def test_init_lm_has_the_reference_structure():
    jcfg, cfg = _cfgs("float32")
    params = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(params))
    shapes = jax.eval_shape(lambda: jax_tf.init_lm(jax.random.PRNGKey(0), jcfg))
    want = jax.tree.map(lambda s: s.shape[1:], shapes["blocks"])
    for blk in params["blocks"]:
        assert jax.tree.map(lambda t: tuple(t.shape), blk) == want
    assert params["embed"].shape == (SMALL["vocab_size"], 192)
    assert "lm_head" not in params                    # tied embeddings
    n_ref = jax_common.count_params(shapes)
    assert common.count_params(params) == n_ref
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))


@pytest.mark.parametrize("init", [transformer.init_lm, transformer.init_block,
                                  attention.init_attention, ffn.init_ffn],
                         ids=lambda f: f.__name__)
def test_init_without_a_device_means_the_card(init):
    """As ``init_mlp``: no device is the card, and without one it raises
    rather than drawing on the CPU."""
    _, cfg = _cfgs("float32")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(cfg, torch.Generator().manual_seed(0))
    p = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p),
                                                  jax.tree.leaves(q)))


@pytest.mark.parametrize("change", [
    dict(family="encdec"), dict(family="vlm"),
    dict(family="vlm", use_flash=True, use_kernel_matmul=True)])
def test_what_is_not_ported_raises(change):
    """Enc-dec is not a decoder LM: every entry point here raises naming
    ``models/encdec.py``, whatever the kernel flags.  A VLM's language
    model runs the dense path (with the kernel flags, their plain versions
    on the CPU) and matches the JAX package's.  The mlp family raises."""
    tree, tokens = _case()
    _, cfg = _cfgs("float32")
    cfg = cfg.replace(**change)
    params = lm_params_from_numpy(tree, device="cpu")
    toks = torch.from_numpy(tokens)
    if change["family"] == "encdec":
        for call in (lambda: transformer.forward(params, toks, cfg),
                     lambda: transformer.init_lm(cfg, device="cpu"),
                     lambda: transformer.init_cache(cfg, 2, 4, device="cpu"),
                     lambda: transformer.decode_step(params, toks[:, :1], {},
                                                     0, cfg)):
            with pytest.raises(ValueError, match="models/encdec.py"):
                call()
    else:
        got, aux = transformer.forward(params, toks, cfg)
        assert float(aux) == 0.0
        assert _rel_err(_np(got), _jax_vlm_logits()) < TOL["float32"]
        cache = transformer.init_cache(cfg, 2, 4, device="cpu")
        assert cache["k"].shape == (cfg.n_layers, 2, 4, cfg.n_kv_heads,
                                    cfg.dh)
        assert "blocks" in transformer.init_lm(cfg, device="cpu")
    with pytest.raises(ValueError, match="not a decoder LM"):
        transformer.forward(params, toks, cfg.replace(family="mlp"))


# --- layers ----------------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [True, False])
def test_apply_attention_matches_jax(use_flash):
    tree, _ = _case()
    jcfg, cfg = _cfgs("float32", use_flash=use_flash)
    blk = jax.tree.map(lambda a: a[0], tree["blocks"])
    x = np.random.default_rng(2).standard_normal((B, S, 192)).astype(np.float32)
    want = jax_attn.apply_attention(jax.tree.map(jnp.asarray, blk["attn"]),
                                    jnp.asarray(x), jcfg)
    got = attention.apply_attention(lm_params_from_numpy(
        {"blocks": [blk]}, device="cpu")["blocks"][0]["attn"],
        torch.from_numpy(x), cfg)
    assert got.shape == (B, S, 192)
    assert _rel_err(_np(got), _np(want)) < TOL["float32"]


@pytest.mark.parametrize("use_kernel", [True, False])
def test_apply_ffn_matches_jax(use_kernel):
    """``use_kernel_matmul`` is the port's ``use_pallas_matmul``.  With it,
    both sides run the fused fp32-accumulated product of their ``ops``
    (JAX's bypasses its kernel below 256, here d = 192; the port's wrapper
    takes ``ref_matmul`` on the CPU); without it, plain fp32 matmuls."""
    tree, _ = _case()
    jcfg, cfg = _cfgs("float32")
    jcfg = jcfg.replace(use_pallas_matmul=use_kernel)
    cfg = cfg.replace(use_kernel_matmul=use_kernel)
    blk = jax.tree.map(lambda a: np.asarray(a[1]), tree["blocks"]["ffn"])
    x = np.random.default_rng(4).standard_normal((B, S, 192)).astype(np.float32)
    want = jax_ffn.apply_ffn(jax.tree.map(jnp.asarray, blk), jnp.asarray(x), jcfg)
    before = blocked_matmul.launches
    got = ffn.apply_ffn({k: torch.from_numpy(v) for k, v in blk.items()},
                        torch.from_numpy(x), cfg)
    assert blocked_matmul.launches == before
    assert _rel_err(_np(got), _np(want)) < 1e-5


# --- common pieces ---------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_jax(norm, dtype):
    jcfg, cfg = _cfgs(dtype, norm=norm)
    rng = np.random.default_rng(5)
    x = (3.0 * rng.standard_normal((4, 7, 192)) + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(192)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(192)).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    want = jax_common.apply_norm(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x).astype(JNP[dtype]), jcfg)
    got = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).to(TORCH[dtype]), cfg)
    assert got.dtype == TORCH[dtype]
    # bf16: inputs equal, one output rounding (half an ulp, 2^-9)
    assert _rel_err(_np(got), _np(want)) < (1e-5 if dtype == "float32" else 4e-3)


def test_rope_rotates_halves_like_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 300, 3, 32)).astype(np.float32)
    pos = np.arange(300)[None, :]
    want = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    # fp32 angles up to 299 rad: sin/cos of the same fp32 argument differ
    # between libraries by an ulp of the result
    assert _rel_err(_np(got), _np(want)) < 1e-5
    inter = torch.from_numpy(x).clone()
    inter[..., 0::2], inter[..., 1::2] = torch.from_numpy(x).chunk(2, dim=-1)
    assert _rel_err(_np(common.apply_rope(inter, torch.from_numpy(pos),
                                          10000.0)), _np(want)) > 1e-2


def test_gelu_is_the_tanh_form_and_activations_match_jax():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for name in ("gelu", "silu", "relu", "relu2"):
        want = jax_common.activation(name, jnp.asarray(x))
        got = common.activation(name, torch.from_numpy(x))
        assert _rel_err(_np(got), _np(want)) < 1e-6, name
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert _rel_err(_np(erf), _np(jax_common.activation("gelu",
                                                        jnp.asarray(x)))) > 1e-4
    with pytest.raises(ValueError):
        common.activation("tanh", torch.from_numpy(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(8)
    logits = (4 * rng.standard_normal((3, 50, 257))).astype(np.float32)
    labels = rng.integers(0, 257, (3, 50)).astype(np.int32)
    want = jax_common.softmax_cross_entropy(
        jnp.asarray(logits).astype(JNP[dtype]), jnp.asarray(labels))
    got = common.softmax_cross_entropy(
        torch.from_numpy(logits).to(TORCH[dtype]), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) < 1e-5 * abs(float(want))
