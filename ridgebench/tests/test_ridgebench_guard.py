"""What a run may load and where it may run: no JAX and no JAX package in
a run's process, and no result without a card or without the program."""
import json
import os
import shutil
import subprocess
import sys

from ridgebench import harness

ROOT = harness.ROOT
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

SETUP = """
import sys, time, torch
sys.path[:0] = ["src", "."]
from ridgebench import harness
from ridgebench.tests.small import small_files
cell = sys.argv[1]
files = small_files(cell)
files["kind"].Cell(files["doc"], files["traffic"], 5, torch.device("cpu"))
print(harness.forbidden_loaded())
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "repro"}))
"""


def test_a_cells_setup_loads_no_jax_and_no_jax_package():
    for w in harness.manifest()["workloads"]:
        out = subprocess.run([sys.executable, "-c", SETUP, w["name"]],
                             cwd=ROOT, env=ENV, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"], out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_loaded()


def test_run_without_a_card_prints_no_result():
    cell = harness.manifest()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "ridgebench/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ridgebench", tmp_path / "ridgebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = harness.manifest()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "ridgebench/run.py", "--workload",
                          cell, "--seed", "1", "--seconds", "1", "--trace",
                          "0"], cwd=tmp_path, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
