"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
reduced smollm-135m trains, prints the reference's ``CE`` line and a
Ridgeline report, writes committed checkpoints, and a second invocation with
more steps resumes at the newest one; a mesh other than 1x1 exits 2.
"""
import os
import pathlib
import subprocess
import sys

import torch

from repro_torch.launch import train as train_cli
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


def test_mesh_waits_for_item_12(tmp_path, capsys):
    assert train_cli.main(ARGS + ["--mesh", "2x1", "--ckpt-dir",
                                  str(tmp_path)]) == 2
    assert "item 12" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--steps",
         "2", "--ckpt-dir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "steps 0..1  CE " in out.stdout
