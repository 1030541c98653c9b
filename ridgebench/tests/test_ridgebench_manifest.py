"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""
import json
import math
import re

import pytest

from ridgebench import harness, weights
from ridgebench.model import model_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ridgebench/run.py"]
    assert BENCH["paths"] == ["ridgebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for sec, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                      "source"}),
                      ("per_layer", {"name", "unit", "better", "source",
                                     "layer", "moves"})):
        for m in BENCH[sec]:
            assert set(m) - {"workloads"} == keys
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                               "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for s in ("end_to_end", "per_layer")
                    for m in BENCH[s]]
    assert len(set(metric_names)) == len(metric_names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_budget():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    # a full check of the full 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    w = harness.workload(cell)
    files = harness.cell_files(w)
    assert files["doc"]["name"] == w["config"]
    assert hasattr(files["kind"], "Cell")
    e2e = harness.metrics_of(w, BENCH, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    per = harness.metrics_of(w, BENCH, "per_layer")
    assert per
    for m in per:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in [x["name"] for x in e2e]
    assert files["limits"] and all(v > 0 for v in files["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_ports_config(config):
    """The file states what the port's registry runs, flags aside."""
    from repro_torch.configs import get_config
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    doc = harness.load_json(harness.ROOT / entry["file"])
    assert doc["reduced"] == entry["reduced"]
    cfg = model_config(doc)
    want = get_config(doc["port"]["arch"]).replace(
        use_flash=cfg.use_flash, use_kernel_matmul=cfg.use_kernel_matmul,
        rope_theta=doc["rope_theta"],
        router_aux_weight=doc["router_aux_loss_coef"])
    assert cfg == want


def test_reduced_keys_are_published_elsewhere():
    """Each key ``reduced`` names differs from the value the file keeps
    under ``published``, and no width is among them."""
    for entry in BENCH["configs"]:
        doc = harness.load_json(harness.ROOT / entry["file"])
        assert set(doc.get("published", {})) == set(entry["reduced"])
        for k in entry["reduced"]:
            assert doc[k] != doc["published"][k]
            assert not k.endswith(("_size", "_dim", "_rank", "_heads",
                                   "_per_tok", "expand"))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_weights_are_the_ports_layout(config):
    """Same tree, shapes and element count as the port's ``init_lm`` at a
    reduced size."""
    import torch

    from repro_torch.models.transformer import init_lm
    from ridgebench.tests.small import small_doc
    doc = small_doc(config)
    got = weights.draw(doc, 3, torch.device("cpu"))
    want = init_lm(model_config(doc), device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(got) == shapes(want)
    assert weights.count(doc) == sum(
        math.prod(s) for _, s, _, _ in weights.layout(doc))


def test_weights_follow_the_seed():
    import torch

    from ridgebench.tests.small import small_doc
    doc = small_doc("qwen2-moe-a2.7b")
    a, b, c = (weights.draw(doc, s, torch.device("cpu"))
               for s in (2 ** 31 + 9, 2 ** 31 + 9, 5))
    assert torch.equal(a["lm_head"], b["lm_head"])
    assert not torch.equal(a["lm_head"], c["lm_head"])
