"""Each cell's traffic kind run end to end at a reduced size on the CPU,
through the harness's own run (its look for a card skipped): the window,
the metrics the line reports, and the check against the cell's limits;
then the control and each fault the cell can have, which must come out as
not correct."""
import time

import pytest
import torch

from repro_torch.models import moe

from ridgebench import harness
from ridgebench.kinds import prefill
from ridgebench.readings import planted
from ridgebench.tests.small import small_files

BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
FAULTS = [(c, f) for c in CELLS
          for f in sorted(small_files(c)["kind"].FAULTS)]


def w_kind(cell):
    return small_files(cell)["traffic"]["kind"]


def run(cell, trace=False, seed=SEED, seconds=0.3):
    return harness.run_cell(cell, seed, seconds, trace, CPU,
                            time.perf_counter(), files=small_files(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_reports_its_metrics(cell):
    w = harness.workload(cell)
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(w, BENCH, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res["checks"]) == list(small_files(cell)["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_trace(cell):
    res = run(cell, trace=True)
    assert res["correct"]
    tr = res["trace"]
    assert tr.units >= 1 and tr.window_s > 0
    # the CPU has no device operations: the device's metrics read nothing
    assert "mfu." + w_kind(cell) in res["metrics"]
    assert not any(k.startswith(("device.", "casts_ms", "flash_roofline",
                                 "matmul_roofline")) for k in res["metrics"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the limits."""
    files = small_files(cell)
    c = files["kind"].Cell(files["doc"], files["traffic"], SEED, CPU)
    for i in range(max(c.kept_at) + 1):
        c.unit(i)
    nums = c.check(control=True)
    assert any(nums[k] > lim for k, lim in files["limits"].items()), nums


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    """A run with its timed path broken underneath comes out as not
    correct."""
    with planted(small_files(cell)["kind"], fault):
        res = run(cell)
    assert not res["correct"], res["checks"]


def test_the_window_runs_the_program_untapped_but_in_kept_units(
        monkeypatch):
    """Only the two kept forwards go through ``RouteTap``; each of them
    gives the reference one choice tensor a layer."""
    files = small_files(CELLS[0])
    c = prefill.Cell(files["doc"], files["traffic"], SEED, CPU)
    tapped = []
    real = prefill.RouteTap.__enter__

    def enter(self):
        tapped.append(True)
        return real(self)
    monkeypatch.setattr(prefill.RouteTap, "__enter__", enter)
    route = moe.route
    for i in range(40):
        c.unit(i)
        assert moe.route is route
    assert len(tapped) == 2 and len(c.kept) == 2
    layers = files["doc"]["num_hidden_layers"]
    assert all(len(choices) == layers for _, _, choices in c.kept)


def test_routing_the_tap_cannot_see_is_not_correct(monkeypatch):
    """Where the program routes by another function than ``moe.route``,
    the check cannot follow its choices, and says so by failing."""
    monkeypatch.setattr(prefill.RouteTap, "__call__",
                        lambda self, *a, **k: self.real(*a, **k))
    res = run(CELLS[0])
    assert not res["correct"]
    assert all(c["value"] == prefill.NOT_COMPARED
               for c in res["checks"].values())
