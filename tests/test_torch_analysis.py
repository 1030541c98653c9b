"""repro_torch.analysis against repro.analysis: the unit algebra, the rule
families on their fixtures, the same findings on the same trees, the gate
on the port, and the restored ``@shape_contract`` decorators.

The port's copy is held to the reference finding for finding and
suppression for suppression on the reference's own tree and on
``tests/fixtures/analysis/``; ``python -m repro_torch.analysis`` defaults
to ``src/repro_torch`` and exits 0 there (with no suppression) and 1 on
the fixtures.  Every function the reference decorates carries the same
spec in the port, raises ``ShapeContractError`` on a mismatched broadcast
of numpy or torch operands (``tests/conftest.py`` sets ``REPRO_CHECK``
before any import, so the port's checks are on here), and gives the
reference's values on a grid that broadcasts.
"""
import ast
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro.analysis as jax_analysis
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jax_hardware
from repro.core import sweep as jax_sweep
from repro.distributed import collectives as jax_collectives
from repro.launch import memory as jax_memory
from repro.launch import plan_grid as jax_plan_grid
from repro.resilience import failures as jax_failures
from repro_torch import analysis
from repro_torch.analysis import contracts, report
from repro_torch.analysis.contracts import ShapeContractError
from repro_torch.analysis.units import (BYTES, BYTES_PER_S, DIMENSIONLESS,
                                        FLOPS, FLOPS_PER_S, NAMED_UNITS,
                                        SECONDS, Unit, UnitError, parse_unit)
from repro_torch.configs import get_config
from repro_torch.core import hardware, sweep
from repro_torch.distributed import collectives
from repro_torch.launch import memory, plan_grid
from repro_torch.resilience import failures

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = str(ROOT / "tests" / "fixtures" / "analysis")
SRC_REPRO = str(ROOT / "src" / "repro")
SRC_PORT = str(ROOT / "src" / "repro_torch")
UNIT_NAMES = sorted(NAMED_UNITS)
#: the modules whose functions the reference decorates (port path, ref path)
DECORATED = ("distributed/collectives.py", "resilience/failures.py",
             "core/sweep.py", "launch/plan_grid.py", "launch/memory.py")


# --- the unit algebra -------------------------------------------------------


@pytest.mark.parametrize("a", UNIT_NAMES)
@pytest.mark.parametrize("b", UNIT_NAMES)
def test_unit_algebra_commutes_inverts_and_is_symmetric(a, b):
    ua, ub = parse_unit(a), parse_unit(b)
    assert ua.commensurable(ub) == ub.commensurable(ua)
    assert ua * ub == ub * ua
    assert (ua * ub) / ub == ua
    assert ua / ua == DIMENSIONLESS
    assert parse_unit(str(ua)) == ua


def test_division_produces_the_model_rates_and_powers():
    assert BYTES / BYTES_PER_S == SECONDS
    assert FLOPS / FLOPS_PER_S == SECONDS
    assert BYTES / SECONDS == BYTES_PER_S
    ridge = FLOPS / BYTES
    assert parse_unit(str(ridge)) == ridge
    assert not ridge.commensurable(FLOPS)
    assert SECONDS ** 2 / SECONDS == SECONDS
    assert SECONDS ** 0 == DIMENSIONLESS
    with pytest.raises(UnitError, match="vocabulary"):
        parse_unit("furlongs")
    with pytest.raises(UnitError):
        Unit.of(s=1) ** 1.5


# --- the passes on their fixtures, and against the reference ----------------


@pytest.mark.parametrize("fixture,family", [
    ("bad_units.py", "unit"), ("bad_contract.py", "contract"),
    ("bad_state.py", "state")])
def test_each_rule_family_fires_on_its_fixture(fixture, family):
    findings, _, n = analysis.check_paths([os.path.join(FIXTURES, fixture)])
    assert n == 1
    assert findings and {f.family for f in findings} == {family}


def _as_dicts(result):
    findings, suppressed, n = result
    return [f.to_dict() for f in findings], suppressed, n


@pytest.mark.parametrize("tree", [SRC_REPRO, FIXTURES],
                         ids=["src_repro", "fixtures"])
def test_the_copy_gives_the_references_findings_and_suppressions(tree):
    port = _as_dicts(analysis.check_paths([tree]))
    ref = _as_dicts(jax_analysis.check_paths([tree]))
    assert port == ref
    if tree == FIXTURES:
        assert port[0], "the fixtures must give findings"
    else:
        assert port[1], "the reference tree carries suppressions"


def test_the_port_is_clean_with_no_suppression():
    findings, suppressed, n = analysis.check_paths([SRC_PORT])
    assert findings == [] and suppressed == []
    assert n >= 90
    assert report.SCHEMA == "repro_torch.analysis/v1"


@pytest.mark.parametrize("args,rc", [([], 0), ([FIXTURES], 1)],
                         ids=["default_is_the_port", "fixtures"])
def test_cli_exit_code(args, rc):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"]
                         + args, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == rc, out.stdout[-2000:] + out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("repro_torch.analysis: ")
    if rc == 0:
        assert " 0 finding(s), 0 suppressed" in last


# --- the restored decorators --------------------------------------------------


def _contract_sites(root: str):
    sites = {}
    for rel in DECORATED:
        path = os.path.join(root, rel)
        src = pathlib.Path(path).read_text()
        for node in ast.parse(src).body:
            if not isinstance(node, ast.FunctionDef):
                continue
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and \
                        getattr(dec.func, "id", None) == "shape_contract":
                    sites[(rel, node.name)] = dec.args[0].value
    return sites


def test_every_reference_contract_is_restored_with_its_spec():
    ref = _contract_sites(SRC_REPRO)
    assert len(ref) == 19
    assert _contract_sites(SRC_PORT) == ref
    for rel in DECORATED:
        assert "Shape contract:" not in \
            pathlib.Path(SRC_PORT, rel).read_text()


def test_checking_is_on_under_the_suite_and_toggles():
    assert contracts.checking_enabled()
    prev = contracts.set_checking(False)
    try:
        assert prev is True and not contracts.checking_enabled()
        # unchecked, the mismatch reaches numpy inside the function
        with pytest.raises(ValueError) as info:
            collectives.all_reduce(np.ones(3), np.ones(4))
        assert not isinstance(info.value, ShapeContractError)
    finally:
        contracts.set_checking(prev)


def test_a_torch_tensor_has_its_shape():
    assert contracts._shape_of(torch.zeros(2, 3)) == (2, 3)
    assert contracts._shape_of(torch.tensor(1.0)) == ()


_FM = dict(mtbf_chip_s=3.6e9, restart_s=60.0, reshard_s=30.0)


def _cases(pkg):
    """(name, fn, good kwargs/args, bad args) for every decorated function
    whose contract a call can break, in ``pkg``'s modules."""
    col, fail, swp, mem, pg, hw, cfg = pkg
    fm = fail.FailureModel(**_FM)
    n = np.array([1.0, 2.0, 8.0])
    p = np.array([[1e6], [1e9]])
    return {
        "all_reduce": (col.all_reduce, (p, n), (np.ones(3), np.ones(4))),
        "all_to_all": (col.all_to_all, (p, n), (np.ones(3), np.ones(4))),
        "best_all_reduce_grid": (
            col.best_all_reduce_grid, (p, n, 450e9, 1e-6),
            (np.ones(3), np.ones(4), 1.0, 0.0)),
        "zero_dp_sync": (col.zero_dp_sync, (p, n, np.array([0, 1, 2])),
                         (np.ones(3), np.ones(4), 1)),
        "ep_dispatch_combine": (col.ep_dispatch_combine, (p, n),
                                (np.ones(3), np.ones(4))),
        "pp_boundary_bytes": (col.pp_boundary_bytes, (p, n),
                              (np.ones(3), np.ones(4))),
        # one contracted operand: a wider second operand breaks the output
        "mesh_mtbf_s": (fail.mesh_mtbf_s, (n, 3.6e9),
                        (np.ones(3), np.ones((2, 1)))),
        "young_daly_interval_s": (fail.young_daly_interval_s, (n, p),
                                  (np.ones(3), np.ones(4))),
        "failure_overhead_terms": (
            fail.failure_overhead_terms, (0.1, 2.0, n * 100, p, 90.0),
            (np.ones(3), 1.0, np.ones(4), 1e5, 1.0)),
        "goodput_fraction": (fail.goodput_fraction, (0.1, n, p * 1e-9, 0.2),
                             (np.ones(3), np.ones(4), 0.0, 0.0)),
        "goodput_terms": (
            lambda *a: fail.goodput_terms(*a, ckpt_bw=1e9, model=fm),
            (0.1, p, n * 64), (np.ones(3), np.ones(4), 1.0)),
        "eff_grid": (swp.eff_grid, (hw.EfficiencyModel(1e9, 1.5, 0.2), p * n),
                     (types.SimpleNamespace(is_identity=False,
                                            f_half=np.ones((2, 1)), p=1.0,
                                            eff_min=0.1), np.ones(3))),
        "sweep": (lambda *a: swp.sweep(*a, hw.get_hardware("clx")),
                  (p * n, 1e9 * n, p), (np.ones(3), np.ones(4), 1.0)),
        "_pod_masks": (pg._pod_masks, (n, n[:, None], 1.0, 2.0, 4),
                       (np.ones(3), np.ones(4), 1.0, 1.0, 4)),
        "moe_routing_derate": (
            lambda *a: pg.moe_routing_derate(
                *a, n_experts=60, pad_experts=64, top_k=4,
                capacity_factor=1.25), (n, p), (np.ones(3), np.ones(4))),
        "training_working_set": (
            lambda b, d: mem.training_working_set(
                cfg, batch=b, seq=128, dp=d, zero_stage=1),
            (np.array([[8.0], [64.0]]), n), (np.ones(3), np.ones(4))),
        "decode_working_set": (
            lambda b, d: mem.decode_working_set(cfg, batch=b, seq=128, dp=d),
            (np.array([[8.0], [64.0]]), n), (np.ones(3), np.ones(4))),
        "min_zero_stage": (
            lambda b, d: mem.min_zero_stage(cfg, 80e9, batch=b, seq=128,
                                            dp=d),
            (np.array([[8.0], [64.0]]), n), (np.ones(3), np.ones(4))),
    }


PORT = (collectives, failures, sweep, memory, plan_grid, hardware,
        get_config("qwen2-7b"))
REF = (jax_collectives, jax_failures, jax_sweep, jax_memory, jax_plan_grid,
       jax_hardware, jax_get_config("qwen2-7b"))
CASES = sorted(_cases(PORT))


def test_the_cases_cover_every_contract_a_call_can_break():
    # ckpt_time_s has one contracted operand and a scalar bandwidth that it
    # tests with ``if``: no call reaches its check with a wrong shape
    names = {name for _, name in _contract_sites(SRC_PORT)}
    assert names - set(CASES) == {"ckpt_time_s"}
    assert failures.ckpt_time_s.__shape_contract__.spec == \
        "persisted_bytes:(*g) -> (*g)"


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("name", CASES)
def test_a_mismatched_broadcast_raises(name, as_torch):
    fn, _, bad = _cases(PORT)[name]
    if as_torch:
        bad = tuple(torch.from_numpy(np.asarray(a, dtype=np.float64))
                    if isinstance(a, np.ndarray) else a for a in bad)
    with pytest.raises(ShapeContractError):
        fn(*bad)


def _values(out):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return [_values(o) for o in out]
    if hasattr(out, "__dataclass_fields__"):
        return {k: _values(getattr(out, k)) for k in out.__dataclass_fields__
                if not k.startswith("_")}
    if isinstance(out, (np.ndarray, float, int, np.generic)):
        return np.asarray(out, dtype=np.float64).tolist()
    return out


@pytest.mark.parametrize("name", CASES)
def test_the_decorated_function_gives_the_references_values(name):
    fn, good, _ = _cases(PORT)[name]
    ref_fn, ref_good, _ = _cases(REF)[name]
    assert _values(fn(*good)) == _values(ref_fn(*ref_good))
