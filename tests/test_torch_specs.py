"""The port's parameter counting and input shapes against ``repro.launch.specs``
and ``repro.configs.shapes``.

The port counts on fake tensors (``FakeTensorMode`` around the real
``init_*``) where the reference counts on ``jax.eval_shape``; both classify
each leaf by its path.  The counts are integers far below 2**53 and the MoE
fractions are powers of two, so the sums are exact whatever the order of
the leaves: the cases hold them equal as floats, for every assigned config
(and dlrm-mlp) at full width and reduced.
"""
import resource
import time

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro import configs as jax_configs
from repro.configs import shapes as jax_shapes
from repro.launch import plan_grid as jax_plan_grid
from repro.launch import specs as jax_specs
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import plan_grid, specs
from repro_torch.models import transformer
from repro_torch.tree import tree_leaves

ARCHS = configs.list_archs()


def _cfgs(arch, reduced):
    if reduced:
        return configs.get_reduced(arch), jax_configs.get_reduced(arch)
    return configs.get_config(arch), jax_configs.get_config(arch)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_equal_the_reference(arch, reduced):
    cfg, jcfg = _cfgs(arch, reduced)
    assert specs.param_counts(cfg) == jax_specs.param_counts(jcfg)
    assert specs.expert_param_counts(cfg) == \
        jax_specs.expert_param_counts(jcfg)
    assert plan_grid.param_counts(cfg) == jax_plan_grid.param_counts(jcfg)
    for name in shapes.SHAPES:
        assert specs.model_flops(cfg, shapes.SHAPES[name]) == \
            jax_specs.model_flops(jcfg, jax_shapes.SHAPES[name]), name


def test_shapes_equal_the_reference():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == \
        {k: vars(v) for k, v in jax_shapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC_FAMILIES == jax_shapes.SUBQUADRATIC_FAMILIES
    for family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "mlp"):
        assert shapes.cells(family) == jax_shapes.cells(family)
        for s in shapes.SHAPES:
            assert shapes.applicable(family, s) == \
                jax_shapes.applicable(family, s)
    assert configs.SHAPES is shapes.SHAPES          # the registry re-exports


def test_fake_params_have_the_real_init_shapes():
    """The fake tree is the tree ``init_lm`` builds: same leaves, same
    shapes, same order (reduced qwen2-moe, drawn for real on the CPU)."""
    cfg = configs.get_reduced("qwen2-moe-a2.7b")
    real = transformer.init_lm(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    fake = specs.abstract_params(cfg)
    assert [tuple(t.shape) for t in tree_leaves(fake)] == \
        [tuple(t.shape) for t in tree_leaves(real)]
    assert all(isinstance(t, FakeTensor) for t in tree_leaves(fake))


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def test_full_width_qwen3_moe_counts_without_allocating():
    """122 GB of fp32 params counted in seconds with no tensor memory."""
    cfg = configs.get_config("qwen3-moe-30b-a3b")
    before = _rss_bytes()
    t0 = time.perf_counter()
    leaves = tree_leaves(specs.abstract_params(cfg))
    seconds = time.perf_counter() - t0
    grown = _rss_bytes() - before
    n = sum(t.numel() for t in leaves)
    assert n == jax_specs.param_counts(
        jax_configs.get_config("qwen3-moe-30b-a3b"))[0]
    assert 4 * n > 120e9
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert grown < 256 * 2 ** 20, grown
    assert seconds < 30.0, seconds


def test_counts_are_memoized():
    cfg = configs.get_config("qwen2-7b")
    specs.param_counts(cfg)
    hits = specs.param_counts.cache_info().hits
    assert specs.param_counts(cfg) == specs.param_counts(cfg)
    assert specs.param_counts.cache_info().hits == hits + 2
    assert specs.expert_param_counts(configs.get_config("qwen2-7b")) == \
        (0.0, 0.0)
