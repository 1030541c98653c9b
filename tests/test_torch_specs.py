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


# ---- the sharded half ----------------------------------------------------------
#
# Each leaf's spec and local shard shape against the reference's
# ``_drop_nondividing(logical_spec(...))`` and ``NamedSharding.shard_shape``
# on the same abstract mesh, under the reference's rules for the cell
# (``repro.launch.dryrun._rules_for``: train_4k for the params and the train
# state, decode_32k for the cache).  Where the reference stacks a model's
# blocks on a leading "layers" axis the port has a list of per-layer trees:
# each of the port's layers is held to the stacked leaf without its layer
# entry.

import functools  # noqa: E402
import os  # noqa: E402

from jax.sharding import NamedSharding as JaxNamedSharding  # noqa: E402

from repro.distributed import sharding as jax_sharding  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
from repro.launch.mesh import make_mesh as jax_make_mesh  # noqa: E402
from repro.train import loop as jax_loop  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.train import loop  # noqa: E402

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jax_dryrun  # noqa: E402  (sets XLA_FLAGS)
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((64, 4), ("data", "model")), ((1, 1), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "64x4", "1x1"]


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(port params fake, reference params, reference cache or None,
    port cache or None) at full width."""
    cfg, jcfg = _cfgs(arch, False)
    jparams = jax_specs.abstract_params(jcfg)
    pparams = specs.abstract_params(cfg)
    if cfg.family == "mlp":
        return pparams, jparams, None, None
    jcache = jax_specs.abstract_cache(jcfg, jparams,
                                      jax_shapes.SHAPES["decode_32k"])
    pcache = specs.abstract_cache(cfg, pparams, shapes.SHAPES["decode_32k"])
    return pparams, jparams, jcache, pcache


def _rules(jcfg, mesh_shape, names, shape_name):
    """(port rules, reference rules filtered by its ``use_sharding``)."""
    shape = jax_shapes.SHAPES[shape_name]
    jrules = jax_dryrun._rules_for(jcfg, jax_abstract_mesh(mesh_shape, names),
                                   shape)
    with jax_sharding.use_sharding(jax_make_mesh((1,) * len(names), names),
                                   jrules) as filtered:
        jrules = dict(filtered)
    return jrules


def _pairs(port, ref_specs, ref_shapes, stacked=False, path=""):
    """(path, port record, reference spec, reference shape, stacked) for
    every leaf; a port list against a reference dict is the stacked layer
    axis."""
    if isinstance(port, specs.Abstract):
        yield path, port, ref_specs, tuple(ref_shapes.shape), stacked
    elif isinstance(port, dict):
        assert set(port) == set(ref_specs), (path, set(port), set(ref_specs))
        for k in port:
            yield from _pairs(port[k], ref_specs[k], ref_shapes[k], stacked,
                              f"{path}/{k}")
    elif isinstance(port, list) and isinstance(ref_specs, dict):
        for i, sub in enumerate(port):
            assert ref_specs, path
            yield from _pairs(sub, ref_specs, ref_shapes, True,
                              f"{path}/{i}")
    else:
        assert len(port) == len(ref_specs), path
        for i, sub in enumerate(port):
            yield from _pairs(sub, ref_specs[i], ref_shapes[i], stacked,
                              f"{path}/{i}")


def _check(port_tree, ref_specs, ref_shapes, jrules, jmesh):
    n = 0
    for path, rec, axes, jshape, stacked in _pairs(port_tree, ref_specs,
                                                   ref_shapes):
        want = jax_sharding._drop_nondividing(
            jax_sharding.logical_spec(axes, jrules), jshape, jmesh)
        local = JaxNamedSharding(jmesh, want).shard_shape(jshape)
        want = tuple(want)
        if stacked:
            assert axes[0] == "layers" and want[0] is None, path
            want, local, jshape = want[1:], local[1:], jshape[1:]
        assert rec.shape == jshape, path
        assert rec.spec == want, (path, rec.spec, want)
        assert rec.local_shape == local, (path, rec.local_shape, local)
        assert rec.placements == sh.to_placements(rec.spec, jmesh_port(jmesh))
        n += 1
    assert n > 0


def jmesh_port(jmesh):
    return mesh_mod.make_abstract_mesh(tuple(jmesh.axis_sizes),
                                       tuple(jmesh.axis_names))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_params_state_and_cache_equal_the_reference(arch, mesh):
    """Params, the train state under ZeRO-1 and FSDP (params and moments),
    and the decode cache: each leaf's spec and local shard shape."""
    mesh_shape, names = mesh
    cfg, jcfg = _cfgs(arch, False)
    pparams, jparams, jcache, pcache = _trees(arch)
    am = mesh_mod.make_abstract_mesh(mesh_shape, names)
    jmesh = jax_abstract_mesh(mesh_shape, names)
    train = _rules(jcfg, mesh_shape, names, "train_4k")
    port_train = dryrun._rules_for(cfg, am, shapes.SHAPES["train_4k"])
    with sh.use_sharding(am, port_train):
        _check(specs.attach(pparams, loop.model_param_specs(cfg), am),
               jax_loop.model_param_specs(jcfg), jparams, train, jmesh)
        for zero1, fsdp in ((True, False), (False, True)):
            ps = specs.train_state_specs(cfg, zero1=zero1, fsdp=fsdp)
            js = jax_specs.train_state_specs(jcfg, zero1=zero1, fsdp=fsdp)
            assert ps.step == js.step == () and ps.rng == js.rng
            for mine, ref in ((ps.params, js.params),
                              (ps.opt_state.mu, js.opt_state.mu),
                              (ps.opt_state.nu, js.opt_state.nu)):
                _check(specs.attach(pparams, mine, am), ref, jparams, train,
                       jmesh)
    if jcache is None:
        return
    decode = _rules(jcfg, mesh_shape, names, "decode_32k")
    with sh.use_sharding(am, dryrun._rules_for(cfg, am,
                                               shapes.SHAPES["decode_32k"])):
        _check(specs.attach(pcache, specs.cache_logical_specs(cfg, pcache),
                            am),
               jax_specs.cache_logical_specs(jcfg, jcache), jcache, decode,
               jmesh)


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_lay_the_batch_out_as_the_reference(kind):
    am = mesh_mod.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    jmesh = jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    for arch in ("smollm-135m", "whisper-tiny", "internvl2-26b", "dlrm-mlp"):
        cfg, jcfg = _cfgs(arch, False)
        shape = shapes.SHAPES[kind]
        port_rules = dryrun._rules_for(cfg, am, shape)
        with sh.use_sharding(am, port_rules):
            mine = (specs.decode_input_specs(cfg, shape, am)
                    if kind == "decode_32k" and cfg.family != "mlp"
                    else specs.input_specs(cfg, shape, am))
        jrules = _rules(jcfg, (2, 16, 16), ("pod", "data", "model"), kind)
        with jax_sharding.use_sharding(
                jax_make_mesh((1, 1, 1), ("pod", "data", "model")), jrules):
            ref = (jax_specs.decode_input_specs(jcfg, jax_shapes.SHAPES[kind])
                   if kind == "decode_32k" and cfg.family != "mlp"
                   else jax_specs.input_specs(jcfg, jax_shapes.SHAPES[kind]))
            axes = (specs.input_axes(cfg) if "tokens" not in mine
                    or kind != "decode_32k" else
                    {"tokens": ("batch", None)})
            for k, rec in mine.items():
                if k == "pos":
                    assert rec == shape.seq_len - 1
                    continue
                want = jax_sharding._drop_nondividing(
                    jax_sharding.logical_spec(axes[k]), ref[k].shape, jmesh)
                assert rec.shape == tuple(ref[k].shape), (arch, k)
                assert rec.spec == tuple(want), (arch, k, rec.spec, want)
                assert rec.local_shape == \
                    JaxNamedSharding(jmesh, want).shard_shape(ref[k].shape)


def test_attach_on_a_fake_mesh_gives_fake_dtensors():
    cfg = configs.get_reduced("smollm-135m")
    with mesh_mod.fake_mesh((2, 2), ("data", "model")) as mesh:
        with sh.use_sharding(mesh, sh.gqa_safe_rules(cfg.n_kv_heads, mesh)):
            tree = specs.attach(specs.abstract_params(cfg),
                                loop.model_param_specs(cfg), mesh)
        wq = tree["blocks"][0]["attn"]["wq"]
        assert isinstance(wq.to_local(), FakeTensor)
        assert tuple(wq.shape) == (cfg.d_model, cfg.q_dim)
        assert tuple(wq.to_local().shape) == (cfg.d_model, cfg.q_dim // 2)
