"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
reduced smollm-135m trains, prints the reference's ``CE`` line and a
Ridgeline report, writes committed checkpoints, and a second invocation with
more steps resumes at the newest one (reduced hymba, xLSTM and qwen2-moe
too, bit for bit); `--mesh` lays the state out on a
mesh that must be the world (1x1 in one process, 2x1 under torchrun), and
a larger one exits 2; over the model axis (1x2, and 2x2 under the dry-run's
sequence-parallel ZeRO-1 rules) each step's CE and the saved params and
AdamW moments are the one process's.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_reduced
from repro_torch.launch import train as train_cli
from repro_torch.optim.optimizer import AdamW
from repro_torch.train.loop import init_train_state
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--batch",
        "2", "--seq", "16", "--ckpt-every", "4"]


def _steps(root):
    return sorted(n for n in os.listdir(root) if n.startswith("step_"))


def test_trains_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    assert train_cli.main(ARGS + ["--steps", "8", "--ckpt-dir", ckpt]) == 0
    out = capsys.readouterr().out
    assert "steps 0..7  CE " in out
    assert "smollm-135m/train:" in out and "bound" in out
    assert _steps(ckpt) == ["step_000000004", "step_000000008"]

    run = train_cli.train(train_cli.parse_args(
        ARGS + ["--steps", "12", "--ckpt-dir", ckpt]))
    out = capsys.readouterr().out
    assert "steps 8..11  CE " in out
    assert [h["step"] for h in run.history] == list(range(8, 12))
    assert int(run.state.step) == 12 == int(run.state.opt_state.step)
    assert _steps(ckpt) == ["step_000000004", "step_000000008",
                            "step_000000012"]
    assert run.report.work.flops > 0 and run.report.work.mem_bytes > 0
    assert run.report.work.net_bytes == 0.0

    # the resumed run ends where an uninterrupted one does, bit for bit
    # (the CPU's steps are deterministic)
    straight = train_cli.train(train_cli.parse_args(
        ARGS + ["--steps", "12", "--ckpt-dir", str(tmp_path / "straight")]))
    for a, b in zip(tree_leaves(straight.state.params),
                    tree_leaves(run.state.params)):
        assert torch.equal(a, b)
    assert [h["ce"] for h in straight.history[8:]] == \
        [h["ce"] for h in run.history]


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m",
                                  "qwen2-moe-a2.7b"])
def test_family_trains_checkpoints_and_resumes(arch, tmp_path, capsys):
    """The hybrid, ssm and moe families through the CLI (items 8, 9): 4
    steps with checkpoints at 2 and 4, then ``--steps 6`` resumes at 4 and
    ends bit for bit where an uninterrupted 6-step run does (params, AdamW
    moments, CE of each step)."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2"]
    ckpt = str(tmp_path / "ckpt")
    assert train_cli.main(args + ["--steps", "4", "--ckpt-dir", ckpt]) == 0
    assert "steps 0..3  CE " in capsys.readouterr().out
    assert _steps(ckpt) == ["step_000000002", "step_000000004"]
    run = train_cli.train(train_cli.parse_args(
        args + ["--steps", "6", "--ckpt-dir", ckpt]))
    assert [h["step"] for h in run.history] == [4, 5]
    straight = train_cli.train(train_cli.parse_args(
        args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "straight")]))
    capsys.readouterr()
    for a, b in zip(tree_leaves([straight.state.params,
                                 straight.state.opt_state.mu,
                                 straight.state.opt_state.nu]),
                    tree_leaves([run.state.params, run.state.opt_state.mu,
                                 run.state.opt_state.nu])):
        assert torch.equal(a, b)
    assert [h["ce"] for h in straight.history[4:]] == \
        [h["ce"] for h in run.history]
    assert run.report.work.flops > 0


def test_mesh_waits_for_item_12(tmp_path, capsys):
    """The mesh is ported (item 12); one larger than the world exits 2
    before anything is written (more ranks than one process: torchrun on
    the CPU, several cards on the card: item 4)."""
    assert train_cli.main(ARGS + ["--mesh", "2x1", "--ckpt-dir",
                                  str(tmp_path)]) == 2
    err = capsys.readouterr().err
    assert "needs 2 ranks" in err and "item 4" in err
    assert not os.listdir(tmp_path)
    assert not torch.distributed.is_initialized()


def test_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps",
         "2", "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "steps 0..1  CE " in out.stdout


def test_mesh_1x1_trains_as_one_process(tmp_path, capsys):
    """``--mesh 1x1 --device cpu`` is the one-process run: same CE line,
    state left local, the CLI's world of one taken down again."""
    run = train_cli.train(train_cli.parse_args(
        ARGS + ["--steps", "3", "--mesh", "1x1", "--ckpt-dir",
                str(tmp_path / "a")]))
    assert not torch.distributed.is_initialized()
    assert all(type(x) is torch.Tensor for x in tree_leaves(run.state.params))
    assert run.report.work.net_bytes == 0.0
    ref = train_cli.train(train_cli.parse_args(
        ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")]))
    assert [h["ce"] for h in run.history] == [h["ce"] for h in ref.history]
    capsys.readouterr()


def test_two_gloo_ranks_train_and_report_wire_bytes(tmp_path, capsys):
    """``--mesh 2x1`` under torchrun: the data axis splits the batch, the
    step's sync is DTensor's, each rank checkpoints into ``rank<r>/``, and
    the closing report counts one device's wire bytes (the per-device
    counter); the CE line is the one process's."""
    assert train_cli.main(ARGS + ["--steps", "3", "--ckpt-dir",
                                  str(tmp_path / "one")]) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("steps ")]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", port,
         "--log-dir", str(tmp_path / "logs"), "--redirects", "1", "-m",
         "repro_torch.launch.train", *ARGS, "--steps", "3", "--mesh", "2x1",
         "--ckpt-dir", str(tmp_path / "two")], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    # each rank's stdout in a file of its own: the two cannot interleave
    logs = sorted((tmp_path / "logs").rglob("stdout.log"))
    assert len(logs) == 2
    lines = [ln for p in logs for ln in p.read_text().splitlines()]
    assert [ln for ln in lines if ln.startswith("steps ")] == want * 2
    reports = [ln for ln in lines if ln.startswith("smollm-135m/train:")]
    assert len(reports) == 2 and all("I_N=inf" not in r for r in reports)
    assert sorted(os.listdir(tmp_path / "two")) == ["rank0", "rank1"]
    assert _steps(tmp_path / "two" / "rank0") == _steps(tmp_path / "one")


#: one rank of a model-axis run: "cli" runs the train CLI; "sp" runs its
#: step (same init, schedule and batches) under the dry-run's train rules
#: (seq on the model axis, ZeRO-1 moments over the data axis) and saves
#: the full state as the CLI's checkpointer does; each writes its CE
RANK_SCRIPT = """
import json, os, sys
import torch
from repro_torch.launch import train as train_cli
mode, out, *argv = sys.argv[1:]
args = train_cli.parse_args(argv)
if mode == "cli":
    ce = [h["ce"] for h in train_cli.train(args).history]
else:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, make_stream, to_device
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AXES, open_mesh, parse_mesh
    from repro_torch.launch.specs import input_axes, train_state_specs
    from repro_torch.optim.optimizer import AdamW, warmup_cosine
    from repro_torch.train.loop import build_train_step, init_train_state
    from repro_torch.tree import tree_map
    shape = SHAPES["train_4k"]
    cfg = dryrun._prepare_cfg(get_reduced(args.arch).replace(
        compute_dtype=torch.float32,
        **json.loads(os.environ.get("CFG_OVERRIDES", "{}"))), shape)
    opt = AdamW(learning_rate=warmup_cosine(args.lr, 20, args.steps))
    step = build_train_step(cfg, opt)
    stream = make_stream(cfg, DataConfig(seed=args.seed,
                                         global_batch=args.batch,
                                         seq_len=args.seq))
    with open_mesh(parse_mesh(args.mesh), AXES, "cpu") as mesh, \\
            sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh, shape)), \\
            implicit_replication():
        state = sh.place_tree(
            init_train_state(torch.Generator().manual_seed(args.seed), cfg,
                             opt, device="cpu"),
            sh.specs_to_shardings(train_state_specs(cfg, zero1=True), mesh))
        rows = {k: sh.NamedSharding(mesh, sh.logical_spec(a))
                for k, a in input_axes(cfg).items()}
        ce = []
        for i in range(args.steps):
            state, m = step(state, {k: sh.place(v, rows[k]) for k, v in
                                    to_device(stream.batch(i), "cpu").items()})
            ce.append(float(m["ce"]))
        Checkpointer(os.path.join(args.ckpt_dir, "rank" + os.environ["RANK"])
                     ).save(args.steps, tree_map(
                         lambda x: x.full_tensor() if isinstance(x, DTensor)
                         else x, state))
with open(os.path.join(out, "ce" + os.environ["RANK"] + ".json"), "w") as f:
    json.dump(ce, f)
"""


def _restored(ckpt_dir, arch):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    like = init_train_state(torch.Generator().manual_seed(0), cfg,
                            AdamW(learning_rate=1e-3), device="cpu")
    state, _ = Checkpointer(ckpt_dir).restore(like)
    return state


@pytest.mark.parametrize("mode,arch,mesh", [
    ("cli", "smollm-135m", "1x2"),     # 3 heads: replicated; ffn, vocab TP
    ("cli", "qwen2.5-3b", "1x2"),      # 4 q / 2 kv heads: both TP
    ("sp", "smollm-135m", "2x2"),      # seq on model, attention on seq
    ("sp", "qwen2.5-3b", "2x2"),       # seq on model, heads TP, ZeRO-1
])
def test_the_model_axis_trains_as_one_process(tmp_path, capsys, mode, arch,
                                               mesh):
    """Values behind every hand-written gradient placement of the model
    axis (``sharding.sp_matmul``, ``sp_embedding``, the sharded attention
    and cross-entropy, the step's sync into ZeRO-1's layout): each step's
    CE within 1e-5 of one process's, the first AdamW moment (linear in the
    gradients, scale included) and the second within 1e-4 of each leaf's
    largest magnitude, and the params within 5e-5 (AdamW turns the
    rounding noise of a gradient that is ~0 in exact arithmetic, as a key
    bias's, into steps of the learning rate's size)."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--steps", "3", "--ckpt-every", "4"]
    one = train_cli.train(train_cli.parse_args(
        args + ["--ckpt-dir", str(tmp_path / "one")]))
    capsys.readouterr()
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    ranks = 4 if mesh == "2x2" else 2
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(ranks), "--master_addr", "127.0.0.1", "--master_port", port,
         str(script), mode, str(tmp_path), *args, "--mesh", mesh,
         "--ckpt-dir", str(tmp_path / "many")], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [h["ce"] for h in one.history]
    ref = _restored(str(tmp_path / "one"), arch)
    for r in range(ranks):
        ce = json.loads((tmp_path / f"ce{r}.json").read_text())
        assert ce == pytest.approx(want, abs=1e-5)
        got = _restored(str(tmp_path / "many" / f"rank{r}"), arch)
        for a, b in zip(tree_leaves(ref.params), tree_leaves(got.params)):
            torch.testing.assert_close(b, a, rtol=0, atol=5e-5)
        for moments in ("mu", "nu"):
            for a, b in zip(tree_leaves(getattr(ref.opt_state, moments)),
                            tree_leaves(getattr(got.opt_state, moments))):
                torch.testing.assert_close(
                    b, a, rtol=0, atol=1e-4 * float(a.abs().max()))


@pytest.mark.parametrize("arch,mesh,overrides", [
    # groups of 8 tokens on each device's (2, 8) shard, 8 experts over the
    # model axis: the buffers move to their experts by all-to-all and back
    ("qwen2-moe-a2.7b", "2x2", {"moe_group_tokens": 8}),
    # groups of 16: the sequence gathered, each device slices its experts'
    # buffers and the combine is a partial sum
    ("qwen2-moe-a2.7b", "2x2", {"moe_group_tokens": 16}),
    # 8 experts on 3: each expert's hidden axis sharded instead, the partial
    # output reduce-scattered on its 48 channels, or (64 on 3) kept partial
    ("qwen2-moe-a2.7b", "1x3", {"moe_group_tokens": 8, "d_model": 48}),
    ("qwen2-moe-a2.7b", "1x3", {"moe_group_tokens": 8}),
    # the SSD on each device's sequences, v's channels split on the model
    # axis (hymba's Mamba heads, the xLSTM's mLSTM); the sLSTM on DTensors
    ("hymba-1.5b", "2x2", {}),
    ("xlstm-125m", "2x2", {}),
])
def test_the_families_train_sharded_as_one_process(tmp_path, arch, mesh,
                                                   overrides):
    """Values behind the moe, hybrid and ssm families' sharded layouts
    (``moe._groups``, ``_dispatch``, ``_experts``, ``_combine``,
    ``ssd._on_shards``, ``ssm._log_sigmoid``) under the dry-run's
    sequence-parallel ZeRO-1 train rules on gloo ranks: 3 steps' CE and the
    saved state held to the same 3 steps in one process, with the bounds of
    ``test_the_model_axis_trains_as_one_process``."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import DataConfig, make_stream, to_device
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizer import warmup_cosine
    from repro_torch.train.loop import build_train_step
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--steps", "3", "--ckpt-every", "4"]
    cfg = dryrun._prepare_cfg(get_reduced(arch).replace(
        compute_dtype=torch.float32, **overrides), SHAPES["train_4k"])
    opt = AdamW(learning_rate=warmup_cosine(3e-3, 20, 3))
    step = build_train_step(cfg, opt)
    stream = make_stream(cfg, DataConfig(seed=0, global_batch=4, seq_len=16))
    ref = init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                           device="cpu")
    want = []
    for i in range(3):
        ref, m = step(ref, to_device(stream.batch(i), "cpu"))
        want.append(float(m["ce"]))
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    ranks = 4 if mesh == "2x2" else 3
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CFG_OVERRIDES=json.dumps(overrides))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(ranks), "--master_addr", "127.0.0.1", "--master_port", port,
         str(script), "sp", str(tmp_path), *args, "--mesh", mesh,
         "--ckpt-dir", str(tmp_path / "many")], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    for r in range(ranks):
        ce = json.loads((tmp_path / f"ce{r}.json").read_text())
        assert ce == pytest.approx(want, abs=1e-5)
        got, _ = Checkpointer(str(tmp_path / "many" / f"rank{r}")).restore(
            init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                             device="cpu"))
        for a, b in zip(tree_leaves(ref.params), tree_leaves(got.params)):
            torch.testing.assert_close(b, a, rtol=0, atol=5e-5)
        for moments in ("mu", "nu"):
            for a, b in zip(tree_leaves(getattr(ref.opt_state, moments)),
                            tree_leaves(getattr(got.opt_state, moments))):
                torch.testing.assert_close(
                    b, a, rtol=0, atol=1e-4 * float(a.abs().max()))
