"""The port's dry-run (``repro_torch.launch.dryrun``) and its per-device
counter (``measure.counters.MeshCounter``) on the CPU.

A cell lowers by running the real step once on fake DTensors over the
``"fake"`` process group: the rules, the mesh names and the config
preparation are held to the reference's (``repro.launch.dryrun``, imported
with ``XLA_FLAGS`` put back as it was), the data-parallel wire bytes to the
ring all-reduce of the fp32 params and to the planner's dp term, the
counts to the plain step's, and the k = 2, 4 fit to the full depth.  Cells
run at reduced widths (``overrides``), so each takes a second or two.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jax_configs
from repro.configs import shapes as jax_shapes
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import H100_SXM, CellReport
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.plan import plan
from repro_torch.measure import counters
from repro_torch.optim.optimizer import AdamW
from repro_torch.train import loop

_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.core import hlo_analysis  # noqa: E402
from repro.launch import dryrun as jax_dryrun  # noqa: E402  (sets XLA_FLAGS)
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

ARCHS = configs.list_archs()
MESHES = ["16x16", "2x16x16", "64x4", "1x1"]
#: dlrm-mlp at its reduced widths, as ``configs.get_reduced`` gives them
SMALL_MLP = dict(mlp_widths=(64,) * 3, n_layers=3, d_model=64)
#: smollm-135m at its reduced widths: 3 heads, which no even axis divides
SMALL_LM = dict(n_layers=3, d_model=48, n_heads=3, n_kv_heads=3, d_ff=128,
                vocab_size=512)


def _mesh_pair(name):
    shape, axes = dryrun._mesh_from_name(name)
    return (mesh_mod.make_abstract_mesh(shape, axes),
            jax_abstract_mesh(shape, axes))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_config_equal_the_reference(arch, mesh):
    pm, jm = _mesh_pair(mesh)
    assert dryrun._mesh_from_name(mesh) == (tuple(jm.axis_sizes),
                                           tuple(jm.axis_names))
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        cfg = dryrun._prepare_cfg(configs.get_config(arch), shape)
        jcfg = jax_dryrun._prepare_cfg(jax_configs.get_config(arch), jshape)
        assert (cfg.remat, cfg.max_seq_len) == (jcfg.remat, jcfg.max_seq_len)
        assert dryrun._rules_for(cfg, pm, shape) == \
            jax_dryrun._rules_for(jcfg, jm, jshape), name
    assert dryrun.FSDP_THRESHOLD == jax_dryrun.FSDP_THRESHOLD
    assert dryrun.POD_SIZE == jax_dryrun.POD_SIZE


def test_a_two_pod_mesh_lowers_as_pod_by_data_rows():
    assert dryrun._lowering_mesh((2, 16, 16), ("pod", "data", "model")) == \
        ((32, 16), ("data", "model"))
    assert dryrun._lowering_mesh((64, 4), ("data", "model")) == \
        ((64, 4), ("data", "model"))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_data_parallel_wire_bytes_are_the_ring_all_reduce_of_the_params(n):
    """ZeRO-1 reduce-scatters each grad into its moments and gathers the
    params back: 2 (n - 1) / n of the fp32 param bytes, the planner's dp
    term (within 1%: the loss and the grad norm add a few scalars)."""
    rep, low = dryrun.lower_cell("dlrm-mlp", "train_4k", f"{n}x1",
                                 overrides=SMALL_MLP)
    cfg = configs.get_config("dlrm-mlp").replace(**SMALL_MLP)
    param_bytes = 4 * specs.param_counts(cfg)[0]
    want = 2 * (n - 1) / n * param_bytes
    assert low.wire_bytes == pytest.approx(want, rel=1e-2)
    dp = [p for p in plan(cfg, H100_SXM, n, batch=256, algorithms=("ring",))
          if (p.dp, p.tp) == (n, 1)]
    assert dp and low.wire_bytes == pytest.approx(dp[0].net_bytes, rel=1e-2)
    assert set(low.wire_bytes_by_kind) <= {"reduce-scatter", "all-gather",
                                          "all-reduce"}
    assert rep.num_devices == n and rep.hardware == H100_SXM.name
    assert not dist.is_initialized()


def test_one_device_counts_are_the_plain_steps():
    """At 1x1 the lowering counts the step the CPU runs on real tensors."""
    cfg = configs.get_config("dlrm-mlp").replace(**SMALL_MLP)
    _, low = dryrun.lower_cell("dlrm-mlp", "train_4k", "1x1",
                               overrides=SMALL_MLP)
    opt = AdamW(learning_rate=1e-3)
    state = loop.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                  device="cpu")
    rng = np.random.default_rng(0)
    batch = {"features": torch.from_numpy(
        rng.standard_normal((256, 64), np.float32)),
        "click": torch.from_numpy((rng.random(256) < .5).astype(np.float32))}
    flops, _ = counters.count(loop.build_train_step(cfg, opt), state, batch)
    assert low.flops == flops
    assert low.wire_bytes == 0.0
    assert low.peak_memory_per_device > 4 * 4 * specs.param_counts(cfg)[0]


def test_per_device_flops_are_what_the_layout_leaves_each_device():
    """3 heads on a 2-wide model axis: the attention runs sequence-parallel
    (each device's query rows against every key) and the projections on
    each device's own rows, so a device does 1/N of the work and nothing
    is replicated; the mlp family's weights are replicated over the model
    axis, so each of its 2 columns does the same work (2/N)."""
    _, one = dryrun.lower_cell("smollm-135m", "train_4k", "1x1",
                               overrides=SMALL_LM, probe=False)
    _, four = dryrun.lower_cell("smollm-135m", "train_4k", "2x2",
                                overrides=SMALL_LM, probe=False)
    assert 4 * four.flops == one.flops
    assert four.wire_bytes > 0 and one.wire_bytes == 0
    _, one = dryrun.lower_cell("dlrm-mlp", "train_4k", "1x1",
                               overrides=SMALL_MLP)
    _, four = dryrun.lower_cell("dlrm-mlp", "train_4k", "2x2",
                                overrides=SMALL_MLP)
    assert 4 * four.flops == 2 * one.flops


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_the_layer_fit_equals_the_full_depth(shape):
    """cost(L) = a + b L read at L = 3 from k = 2 and 4 is the count at 3."""
    over = dict(SMALL_LM, n_layers=3)
    _, fit = dryrun.lower_cell("smollm-135m", shape, "2x2", overrides=over)
    _, full = dryrun.lower_cell("smollm-135m", shape, "2x2", overrides=over,
                                probe=False)
    for got, want in ((fit.flops, full.flops), (fit.mem_bytes, full.mem_bytes),
                      (fit.wire_bytes, full.wire_bytes),
                      (fit.peak_memory_per_device,
                       full.peak_memory_per_device)):
        assert got == pytest.approx(want, rel=1e-9)
    for kind, b in full.wire_bytes_by_kind.items():
        assert fit.wire_bytes_by_kind[kind] == pytest.approx(b, rel=1e-9)


def test_cross_pod_bytes_come_from_the_groups_ranks():
    _, low = dryrun.lower_cell("dlrm-mlp", "train_4k", "2x16x16",
                               overrides=SMALL_MLP)
    # every dp group of 32 spans both pods: 2 of its 32 ring hops cross
    assert low.cross_pod_wire_bytes == pytest.approx(low.wire_bytes / 16,
                                                     rel=1e-2)
    groups = np.arange(512).reshape(2, 16, 16).transpose(2, 0, 1).reshape(
        16, 32)
    for pod in (256, 128, 64):
        assert counters.cross_pod_fraction(groups[0], pod) == \
            hlo_analysis._cross_pod_fraction(groups, pod)
    for kind, f in counters.COLLECTIVE_FACTORS.items():
        for n in (1, 2, 16, 32):
            assert f(n) == hlo_analysis._COLLECTIVE_KINDS[kind](n)


def _reduced(arch):
    """The reduced config's fields as overrides of the full one but the
    SSD's chunk (one of 8 would loop 512 times at 4096 tokens) and the
    learned positions (the cell's sequence sets their table)."""
    import dataclasses
    full, small = configs.get_config(arch), configs.get_reduced(arch)
    return {f.name: getattr(small, f.name)
            for f in dataclasses.fields(small)
            if f.name not in ("name", "ssm_chunk", "max_seq_len")
            and getattr(small, f.name) != getattr(full, f.name)}


@pytest.mark.parametrize("arch, shape, mesh", [
    ("qwen2-moe-a2.7b", "train_4k", "4x2"),     # experts over the model axis
    ("qwen2-moe-a2.7b", "train_4k", "2x3"),     # each expert's hidden axis
    ("hymba-1.5b", "train_4k", "4x2"),
    ("xlstm-125m", "train_4k", "4x2"),
    ("whisper-tiny", "prefill_32k", "4x2"),
    ("internvl2-26b", "train_4k", "4x2")])
def test_every_family_lowers(arch, shape, mesh):
    """A cell of each family that waited for item 12 step 7, at reduced
    widths: a report with F per device, wire bytes by kind and peak bytes;
    a train cell's data parallelism moves the grads (ZeRO-1: a
    reduce-scatter and an all-gather), and the MoE's tokens reach experts
    sharded on their own mesh axis by all-to-all."""
    rep, low = dryrun.lower_cell(arch, shape, mesh, overrides=_reduced(arch))
    assert not dist.is_initialized()
    kind = {"train": "train_step", "prefill": "prefill_step"}[
        shapes.SHAPES[shape].kind]
    assert rep.step_kind == kind and rep.num_devices == 8 - 2 * (mesh == "2x3")
    assert low.flops > 0 and low.mem_bytes > 0
    assert low.peak_memory_per_device > 0 and rep.bottleneck
    assert low.wire_bytes == pytest.approx(
        sum(low.wire_bytes_by_kind.values()))
    if kind == "train_step":
        assert {"reduce-scatter", "all-gather"} <= set(low.wire_bytes_by_kind)
    if (arch, mesh) == ("qwen2-moe-a2.7b", "4x2"):
        assert low.wire_bytes_by_kind["all-to-all"] > 0


def test_cli_writes_a_report_and_counts_failures(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "dlrm-mlp", "--shape", "train_4k",
                        "--mesh", "4x1", "--set", "mlp_widths=64",
                        "--out", out]) != 0          # a bad override fails
    assert dryrun.main(["--arch", "dlrm-mlp", "--shape", "decode_32k",
                        "--mesh", "4x1", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "[OK" in text and "all 1 cells OK" in text
    path = tmp_path / "dlrm-mlp__decode_32k__4x1__baseline.json"
    rep = CellReport.from_json(path.read_text())
    assert rep.step_kind == "serve_step" and rep.num_devices == 4
    assert rep.bottleneck and rep.peak_memory_per_device > 0
    # every family lowers (item 12 step 7): hymba's decode cell too
    assert dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                        "--mesh", "4x1", "--out", out]) == 0
    assert "[OK" in capsys.readouterr().out


def test_cli_sets_a_cell_against_its_1x1_report(tmp_path, capsys):
    """With the cell's 1x1 report in ``--out``, a mesh's line gives F x N
    over the 1x1 F beside its wire bytes by kind."""
    out = str(tmp_path)
    cell = ["--arch", "dlrm-mlp", "--shape", "decode_32k", "--out", out]
    assert dryrun.main(cell + ["--mesh", "4x1"]) == 0
    assert "F(1x1)" not in capsys.readouterr().out
    assert dryrun.main(cell + ["--mesh", "1x1"]) == 0
    assert dryrun.main(cell + ["--mesh", "4x1", "--force"]) == 0
    line = capsys.readouterr().out.splitlines()[-3]
    one, four = (CellReport.from_json((
        tmp_path / f"dlrm-mlp__decode_32k__{m}__baseline.json").read_text())
        for m in ("1x1", "4x1"))
    assert line.startswith("[OK") and "4x1" in line
    assert line.endswith(f"F x N / F(1x1) {four.flops * 4 / one.flops:.4f}")
    assert "(none)" in line or all(k in line
                                   for k in four.wire_bytes_by_kind)


def test_mesh_counter_counts_one_device_of_a_dtensor_product():
    """FlopCounterMode counts the global product; MeshCounter the shard's."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as sh
    with mesh_mod.fake_mesh((4,), ("data",)) as mesh:
        x = sh.place(torch.randn(16, 8), sh.NamedSharding(mesh, ("data",)))
        w = sh.place(torch.randn(8, 32), sh.NamedSharding(mesh, ()))
        assert x.placements == (Shard(0),) and w.placements == (Replicate(),)
        with FlopCounterMode(display=False) as global_count:
            x @ w
        counter = counters.MeshCounter()
        with counter:
            y = (x @ w).redistribute(mesh, (Replicate(),))
    assert global_count.get_total_flops() == 2 * 16 * 8 * 32
    assert counter.flops == 2 * 4 * 8 * 32
    ops = counter.summary.ops
    assert [o.kind for o in ops] == ["all-gather"]
    assert ops[0].group_size == 4
    assert ops[0].bytes_result == 16 * 32 * 4
    assert ops[0].wire_bytes == 3 / 4 * 16 * 32 * 4
    assert y.shape == (16, 32)
