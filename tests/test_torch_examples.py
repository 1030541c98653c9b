"""The examples' counterparts on the port (``examples/*_torch.py``).

Each runs in a subprocess on the CPU (``--device cpu``) at the reference
example's own sizes and must exit 0 and print ``OK``; each imports nothing
of ``jax``, ``ml_dtypes`` or ``repro`` (the AST scan of
``tests/test_torch_import.py``).  The quickstart runs 100 steps, the fewest
at which the reference example's own ``last < first - 0.2`` holds (at 60
the reference reads 6.246 -> 6.05 and fails it too).
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
NAMES = ("serve_demo", "dlrm_case_study", "plan_demo", "quickstart",
         "ridgeline_analysis")
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
#: extra arguments beyond ``--device cpu``
ARGS = {"quickstart": ["--steps", "100"]}


def test_every_reference_example_has_its_counterpart():
    reference = {p.stem for p in EXAMPLES.glob("*.py")
                 if not p.stem.endswith("_torch")}
    ported = {p.stem[:-len("_torch")] for p in EXAMPLES.glob("*_torch.py")}
    assert reference == set(NAMES) == ported


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu_and_says_ok(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py"), "--device",
         "cpu"] + ARGS.get(name, []),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "OK" in out.stdout.splitlines()[-1]


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_nothing_forbidden(name):
    path = EXAMPLES / f"{name}_torch.py"
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names
                      if a.name.split(".")[0] in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and (node.module or "").split(".")[0] in FORBIDDEN:
            found.append(node.module)
    assert not found, f"{path.name} imports {found}"
    assert "import repro_torch" in path.read_text() or \
        "from repro_torch" in path.read_text()
