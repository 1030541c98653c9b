"""The port's mesh and logical sharding rules (``repro_torch.launch.mesh``,
``repro_torch.distributed.sharding``) against ``repro.distributed.sharding``.

The rule functions are compared with the reference's on the same axes and
``make_abstract_mesh`` grids (the cases of ``tests/test_sharding.py`` and
more); the reference's rule filter is read from its own ``use_sharding`` on
a one-device mesh of the same axis names.  DTensor layouts run on the
``"fake"`` process group (``fake_mesh``), which each case opens and closes:
no process group outlives a case.  The kernel wrappers' guard passes a CPU
DTensor to the plain version and refuses a CUDA one (``gpu``-marked).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro.distributed import sharding as jsh
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.blocked_matmul import blocked_matmul
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.ref import ref_matmul
from repro_torch.launch import mesh as mesh_mod

GRIDS = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
         ((64, 4), ("data", "model")), ((1, 1), ("data", "model")),
         ((2, 2), ("data", "model"))]
GRID_IDS = ["x".join(map(str, g)) for g, _ in GRIDS]

AXES = [("batch", "seq", "embed"), ("batch", "seq", "vocab"),
        ("embed", "q_proj"), ("layers", "batch", "kv_seq", "kv_heads", None),
        ("experts", "embed", "expert_ffn"), ("dp_shard", "ffn"), (),
        (None, "embed"), ("batch", "attn_seq", "heads", None)]
RULESETS = {
    "default": {},
    "sp": {"seq": "model"},
    "odd_heads": {"heads": None, "q_proj": None, "seq": "model",
                  "attn_seq": "model"},
    "decode": {"kv_seq": "model", "head_dim": None, "batch": None},
    "experts_tp": {"experts": None, "expert_ffn": "model"},
}


def _jax_rules(overrides, names):
    """The reference's rules as its ``use_sharding`` filters them for a
    mesh of ``names``."""
    with jsh.use_sharding(jax_make_mesh((1,) * len(names), names),
                          overrides) as rules:
        return dict(rules)


def _port_rules(overrides, names):
    with sh.use_sharding(mesh_mod.make_abstract_mesh((1,) * len(names),
                                                     names),
                         overrides) as rules:
        return dict(rules)


def _spec(p):
    return tuple(p)


# ---- rules ------------------------------------------------------------------


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("model",)],
                         ids=["2d", "3d", "1d"])
@pytest.mark.parametrize("rules", sorted(RULESETS))
def test_use_sharding_filters_missing_axes_as_the_reference(names, rules):
    assert _port_rules(RULESETS[rules], names) == _jax_rules(RULESETS[rules],
                                                             names)


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")],
                         ids=["2d", "3d"])
@pytest.mark.parametrize("rules", sorted(RULESETS))
def test_logical_spec_equals_the_reference(names, rules):
    jr, pr = _jax_rules(RULESETS[rules], names), _port_rules(RULESETS[rules],
                                                             names)
    for axes in AXES:
        assert sh.logical_spec(axes, pr) == _spec(jsh.logical_spec(axes, jr))


def test_logical_spec_dedupes_a_mesh_axis():
    rules = dict(sh.DEFAULT_RULES, seq="model")
    assert sh.logical_spec(("batch", "seq", "vocab"), rules) == (
        ("pod", "data"), "model", None)            # vocab dropped
    assert sh.logical_spec(("batch",)) == ()      # no binding, no rules


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_drop_nondividing_equals_the_reference(grid):
    shape_, names = grid
    jm = jax_abstract_mesh(shape_, names)
    pm = mesh_mod.make_abstract_mesh(shape_, names)
    rng = np.random.default_rng(len(names) * 100 + shape_[-1])
    dp = tuple(n for n in names if n != "model")
    entries = [None, "model", "data", dp if len(dp) > 1 else dp[0]]
    for _ in range(60):
        rank = int(rng.integers(1, 5))
        dims = tuple(int(d) for d in rng.choice([1, 7, 12, 16, 32, 48, 64,
                                                 256, 4096], rank))
        spec, used = [], set()
        for _ in range(int(rng.integers(0, rank + 1))):
            e = entries[int(rng.integers(len(entries)))]
            flat = e if isinstance(e, tuple) else (e,) if e else ()
            if used & set(flat) or e == ():
                e = None
            used.update(flat if e else ())
            spec.append(e)
        got = sh._drop_nondividing(tuple(spec), dims, pm)
        want = jsh._drop_nondividing(P(*spec), dims, jm)
        assert got == _spec(want), (spec, dims)
        assert len(got) == len(dims)
        assert sh.local_shape(dims, got, pm) == \
            JaxNamedSharding(jm, want).shard_shape(dims)


@pytest.mark.parametrize("n_kv", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_gqa_safe_rules_equal_the_reference(grid, n_kv):
    shape_, names = grid
    got = sh.gqa_safe_rules(n_kv, mesh_mod.make_abstract_mesh(shape_, names))
    want = jsh.gqa_safe_rules(n_kv, jax_abstract_mesh(shape_, names))
    assert got == want
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES


def test_to_placements_one_per_mesh_dim_in_mesh_order():
    pm = mesh_mod.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.to_placements((("pod", "data"), "model", None), pm) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.to_placements((None, None), pm) == (Replicate(),) * 3
    assert sh.to_placements(("model",), pm) == (Replicate(), Replicate(),
                                                Shard(0))


def test_abstract_mesh_and_axis_sizes():
    m = mesh_mod.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert mesh_mod.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert m.size == mesh_mod.mesh_size(m) == 512
    assert mesh_mod.parse_mesh("64x4") == (64, 4)
    for bad in ("4", "axb", "0x2", ""):
        if bad == "4":
            assert mesh_mod.parse_mesh(bad) == (4,)
            continue
        with pytest.raises(ValueError):
            mesh_mod.parse_mesh(bad)


def test_specs_to_shardings_and_validate_divisibility():
    pm = mesh_mod.make_abstract_mesh((2, 4), ("data", "model"))
    specs = {"w": ("embed", "ffn"), "b": ("ffn",), "x": (None,)}
    with sh.use_sharding(pm):
        shardings = sh.specs_to_shardings(specs, pm)
    assert shardings["w"].spec == (None, "model")
    assert shardings["w"].placements == (Replicate(), Shard(1))
    sh.validate_divisibility({"w": torch.empty(8, 8), "b": torch.empty(8),
                              "x": torch.empty(3)}, shardings)
    with pytest.raises(ValueError, match="not divisible by mesh extent 4"):
        sh.validate_divisibility({"w": torch.empty(8, 6), "b": torch.empty(8),
                                  "x": torch.empty(3)}, shardings)


# ---- the fake mesh and DTensor layouts ---------------------------------------


def test_fake_mesh_opens_and_always_closes():
    with mesh_mod.fake_mesh((2, 4), ("data", "model")) as mesh:
        assert dist.is_initialized() and dist.get_world_size() == 8
        assert mesh_mod.axis_sizes(mesh) == {"data": 2, "model": 4}
        with pytest.raises(RuntimeError, match="already up"):
            with mesh_mod.fake_mesh((2,), ("data",)):
                pass
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with mesh_mod.fake_mesh((2, 2), ("data", "model")):
            raise KeyError("inside")
    assert not dist.is_initialized()


def test_make_mesh_is_the_world_and_never_shrinks():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    with mesh_mod.open_mesh((1, 1), ("data", "model"), device="cpu") as m:
        assert dist.get_world_size() == 1 and mesh_mod.mesh_size(m) == 1
        with pytest.raises(ValueError, match="world has 1"):
            mesh_mod.make_mesh((2, 1), ("data", "model"), device="cpu")
        x = torch.arange(6.0).reshape(2, 3)
        assert sh.place(x, sh.NamedSharding(m, ("data", None))) is x
    assert not dist.is_initialized()


def test_shard_hint_is_the_identity_without_a_binding_or_a_dtensor():
    x = torch.ones(4, 4)
    assert sh.shard_hint(x, ("batch", "embed")) is x
    with sh.use_sharding(mesh_mod.make_abstract_mesh((2, 2),
                                                     ("data", "model"))):
        assert sh.shard_hint(x, ("batch", "embed")) is x


def test_shard_hint_lays_a_dtensor_out_and_place_slices_each_rank():
    with mesh_mod.fake_mesh((2, 4), ("data", "model")) as mesh:
        x = torch.arange(8 * 12 * 6, dtype=torch.float32).reshape(8, 12, 6)
        placed = sh.place(x, sh.NamedSharding(mesh, ("data", "model", None)))
        assert placed.placements == (Shard(0), Shard(1))
        # rank 0 of the fake world holds the first block of rows and seq
        assert torch.equal(placed.to_local(), x[:4, :3])
        # a dim that does not divide its axis is replicated
        odd = sh.place(torch.zeros(8, 7), sh.NamedSharding(mesh,
                                                           (None, "model")))
        assert odd.placements == (Replicate(), Replicate())
        with sh.use_sharding(mesh, {"seq": "model"}):
            hinted = sh.shard_hint(placed, ("batch", None, "embed"))
            assert hinted.placements == (Shard(0), Replicate())
            assert hinted.to_local().shape == (4, 12, 6)
            moved = sh.shard_hint(
                sh.place(x, sh.NamedSharding(mesh, ("data", None, "model"))),
                ("batch", "seq", "embed"))
            assert moved.placements == (Shard(0), Shard(1))
            assert moved.to_local().shape == (4, 3, 6)


@pytest.mark.parametrize("n", [2, 4])
def test_a_seq_to_heads_hint_on_a_cpu_mesh_is_one_all_to_all(n):
    """Moving the model axis from seq to heads on a CPU mesh (the fake one
    here, gloo in the two-rank training tests) is one all-to-all of the
    local shard, (n-1)/n of its bytes on the wire, where DTensor's own CPU
    move would all-gather the whole tensor."""
    from repro_torch.measure.counters import MeshCounter
    with mesh_mod.fake_mesh((1, n), ("data", "model")) as mesh:
        x = sh.place(torch.zeros(2, 16, 8, 4), sh.NamedSharding(
            mesh, (None, "model", None, None)))
        counter = MeshCounter()
        with sh.use_sharding(mesh), counter:
            y = sh.shard_hint(x, (None, None, "heads", None))
        assert y.placements == (Replicate(), Shard(2))
        assert y.to_local().shape == (2, 16, 8 // n, 4)
        local = x.to_local().nbytes
        [op] = counter.collectives
        assert (op.kind, op.group_size, op.bytes_result) == \
            ("all-to-all", n, local)
        assert op.wire_bytes == pytest.approx((n - 1) / n * local, rel=1e-12)

def test_sp_matmul_keeps_the_shards_and_hands_back_partial_grads():
    with mesh_mod.fake_mesh((2, 2), ("data", "model")) as mesh:
        x = sh.place(torch.randn(4, 6, 8), sh.NamedSharding(
            mesh, ("data", "model", None)))
        w_rep = sh.place(torch.randn(8, 4), sh.NamedSharding(mesh, ()))
        y = sh.sp_matmul(x, w_rep)
        assert y.placements == (Shard(0), Shard(1))
        assert y.to_local().shape == (2, 3, 4)
        w_col = sh.place(torch.randn(8, 4), sh.NamedSharding(
            mesh, (None, "model")))
        y = sh.sp_matmul(x, w_col)            # seq gathered, columns sharded
        assert y.placements == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 6, 2)
        w_row = sh.place(torch.randn(4, 8), sh.NamedSharding(
            mesh, ("model", None)))
        z = sh.sp_matmul(y, w_row)
        assert z.placements == (Shard(0), Partial())
    plain = torch.randn(3, 5)
    assert torch.equal(sh.sp_matmul(plain, torch.eye(5)), plain @ torch.eye(5))


# ---- the kernels' guard -------------------------------------------------------


def test_kernel_wrappers_take_the_plain_version_for_a_cpu_dtensor():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((6, 8), np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 5), np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 2, 5, 4), np.float32))
    with mesh_mod.fake_mesh((1, 1), ("data", "model")) as mesh:
        rep = (Replicate(), Replicate())
        da, db, dq = (DTensor.from_local(t, mesh, rep, run_check=False)
                      for t in (a, b, q))
        got = blocked_matmul(da, db, act="relu")
        assert isinstance(got, DTensor)
        assert torch.equal(got.to_local(), ref_matmul(a, b, act="relu"))
        with implicit_replication():      # the plain version's masks
            got = flash_attention_bhsd(dq, dq, dq, causal=True)
        assert torch.equal(got.to_local(),
                           flash_attention_bhsd(q, q, q, causal=True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on the H100")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_wrappers_refuse_a_cuda_dtensor(cuda):
    with mesh_mod.open_mesh((1, 1), ("data", "model"), device=cuda) as mesh:
        rep = (Replicate(), Replicate())
        a = DTensor.from_local(torch.ones(4, 4, device=cuda), mesh, rep)
        with pytest.raises(TypeError, match=r"a: .*DTensor laid out as"):
            blocked_matmul(a, a)
        q = DTensor.from_local(torch.ones(1, 1, 4, 64, device=cuda,
                                          dtype=torch.bfloat16), mesh, rep)
        with pytest.raises(TypeError, match=r"q: .*Replicate"):
            flash_attention_bhsd(q, q, q)
    assert not dist.is_initialized()


def test_the_guard_holds_no_reference_to_the_tensors_it_checks():
    """The wrappers' DTensor check keeps nothing: a tensor a kernel call
    saw is freed with its last reference (a cache on the check held every
    activation of a forward alive, 7 GB a qwen2-moe prefill on the card)."""
    import gc
    import weakref
    a, q = torch.ones(6, 8), torch.ones(1, 2, 5, 4)
    refs = [weakref.ref(a), weakref.ref(q)]
    blocked_matmul(a, torch.ones(8, 3))
    flash_attention_bhsd(q, q, q)
    del a, q
    gc.collect()
    assert [r() for r in refs] == [None, None]
