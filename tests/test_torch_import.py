"""The port stands alone: no jax, no ml_dtypes, nothing of ``repro``."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "chip_mutants.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, chip_mutants
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print(json.dumps({"names": names, "bad": bad}))
"""


def test_import_every_module_pulls_in_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(probe["names"]) >= 40     # every submodule was imported
    assert {"repro_torch.tree", "repro_torch.optim.optimizer",
            "repro_torch.train.loop", "repro_torch.distributed.collectives",
            "repro_torch.measure.counters",
            "repro_torch.measure.calibrate", "repro_torch.measure.overlay",
            "repro_torch.obs", "repro_torch.obs.trace",
            "repro_torch.obs.metrics", "repro_torch.obs.__main__",
            "repro_torch.core.ridgeline", "repro_torch.core.roofline",
            "repro_torch.core.report",
            "repro_torch.core.sweep", "repro_torch.serve",
            "repro_torch.serve.engine", "repro_torch.launch",
            "repro_torch.launch.serve",
            "repro_torch.models.moe", "repro_torch.models.ssd",
            "repro_torch.models.mamba", "repro_torch.models.hybrid",
            "repro_torch.models.ssm", "repro_torch.models.encdec",
            "repro_torch.models.vlm", "repro_torch.data.pipeline",
            "repro_torch.optim.compression",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.train.fault_tolerance",
            "repro_torch.resilience.failures",
            "repro_torch.resilience.faults",
            "repro_torch.resilience.harness",
            "repro_torch.launch.train", "repro_torch.configs.shapes",
            "repro_torch.launch.specs", "repro_torch.launch.memory",
            "repro_torch.launch.plan_grid", "repro_torch.launch.plan",
            "repro_torch.obs.explain", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.distributed.sharding",
            "repro_torch.checkpoint.elastic",
            "repro_torch.resilience.degraded"} <= set(probe["names"])
    assert probe["bad"] == [], f"port imported {probe['bad']}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_nothing_forbidden(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and _forbidden(node.module or ""):
            found.append(node.module)
    assert not found, f"{path.name} imports {found}"


def test_no_device_means_the_card_and_raises_without_one():
    import torch

    from repro_torch import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
