"""The port's DLRM MLP tower against the JAX package's, on the CPU.

Widths (256,) x 3 at batch 256, so the JAX kernel path really goes through
the Pallas kernel (interpret mode): ``repro.kernels.ops`` bypasses it below
256.  JAX's own init makes the weights; the biases are overwritten from
numpy so the bias path is exercised; the same numpy tree goes to the port
through ``convert.mlp_params_from_numpy``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mlp_dlrm as jax_mlp
from repro_torch.configs import get_config
from repro_torch.convert import mlp_params_from_numpy
from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.models import mlp_dlrm

WIDTH, LAYERS, BATCH = 256, 3, 256
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = np.maximum(np.max(np.abs(want)), 1e-6)
    return float(np.max(np.abs(got - want))) / denom


def _cfgs(dtype):
    small = dict(n_layers=LAYERS, mlp_widths=(WIDTH,) * LAYERS, d_model=WIDTH)
    return (jax_get_config("dlrm-mlp").replace(compute_dtype=JNP[dtype],
                                               **small),
            get_config("dlrm-mlp").replace(compute_dtype=TORCH[dtype],
                                           **small))


@functools.lru_cache(maxsize=None)
def _case():
    """(numpy param tree, features, clicks) shared by every test."""
    jcfg, _ = _cfgs("float32")
    params = jax_mlp.init_mlp(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    for lyr in tree["layers"]:
        lyr["b"] = (rng.standard_normal(WIDTH) * 0.1).astype(np.float32)
    tree["head"]["b"] = rng.standard_normal(1).astype(np.float32)
    x = rng.standard_normal((BATCH, WIDTH)).astype(np.float32)
    y = (rng.random(BATCH) < 0.3).astype(np.float32)
    return tree, x, y


@functools.lru_cache(maxsize=None)
def _jax_logits(dtype, pallas):
    tree, x, _ = _case()
    jcfg, _ = _cfgs(dtype)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    out = jax_mlp.forward(params, jnp.asarray(x),
                          jcfg.replace(use_pallas_matmul=pallas))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, kernel, jax_pallas):
    tree, x, _ = _case()
    _, cfg = _cfgs(dtype)
    params = mlp_params_from_numpy(tree, device="cpu")
    got = mlp_dlrm.forward(params, torch.from_numpy(x),
                           cfg.replace(use_kernel_matmul=kernel))
    assert got.shape == (BATCH,) and got.dtype == TORCH[dtype]
    assert _rel_err(got.float().numpy(), _jax_logits(dtype, jax_pallas)) \
        < TOL[dtype]


def test_loss_matches_jax():
    tree, x, y = _case()
    jcfg, cfg = _cfgs("float32")
    want = jax_mlp.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                           jnp.asarray(x), jnp.asarray(y), jcfg)
    got = mlp_dlrm.loss_fn(mlp_params_from_numpy(tree, device="cpu"),
                           torch.from_numpy(x), torch.from_numpy(y), cfg)
    assert _rel_err(got.numpy(), np.asarray(want)) < 1e-6


def test_convert_keeps_layout_and_dtype():
    tree, _, _ = _case()
    params = mlp_params_from_numpy(tree, device="cpu")
    for got, want in zip(params["layers"], tree["layers"]):
        assert got["w"].shape == want["w"].shape == (WIDTH, WIDTH)
        assert got["w"].dtype == torch.float32
        assert np.array_equal(got["w"].numpy(), want["w"])
        assert np.array_equal(got["b"].numpy(), want["b"])
    assert params["head"]["w"].shape == (WIDTH, 1)


def test_kernel_path_on_cpu_counts_no_launch():
    tree, x, _ = _case()
    _, cfg = _cfgs("bfloat16")
    before = blocked_matmul.launches
    mlp_dlrm.forward(mlp_params_from_numpy(tree, device="cpu"),
                     torch.from_numpy(x), cfg.replace(use_kernel_matmul=True))
    assert blocked_matmul.launches == before


def test_init_mlp_shapes_and_scale():
    _, cfg = _cfgs("float32")
    params = mlp_dlrm.init_mlp(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert [lyr["w"].shape for lyr in params["layers"]] == \
        [(WIDTH, WIDTH)] * LAYERS
    assert params["head"]["w"].shape == (WIDTH, 1)
    std = params["layers"][0]["w"].std().item()
    assert abs(std - WIDTH ** -0.5) < 0.05 * WIDTH ** -0.5
    assert all(not lyr["b"].any() for lyr in params["layers"])


@pytest.mark.parametrize("args", [(256, 4096, 8), (1, 64, 3), (512, 4096, 8, 2)])
def test_analytic_work_unit_equal(args):
    assert mlp_dlrm.analytic_work_unit(*args) == \
        jax_mlp.analytic_work_unit(*args)
