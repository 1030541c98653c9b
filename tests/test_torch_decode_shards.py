"""Decode attention on the cache's own shards: where a mesh shards the KV
cache's sequence, each device attends over its own keys and no device
gathers the scores.

``attention._sdpa_grouped`` takes ``_sdpa_grouped_on_shards`` for a cache
whose sequence a mesh dim shards: the token's query, whole on that dim,
contracts with the device's keys; the mask is the caller's sliced to them;
the softmax's max and sum are all-reduced over the sequence's mesh dims
and the output is the weights' partial sum there.  DTensor's own softmax
over the sharded last axis all-gathered the (B, K, G, 1, S_max) fp32
scores on every device, every layer, every step.

On fake 2x2 and 1x4 meshes under the dry-run's decode rules (one decode
step of reduced smollm-135m, qwen2-moe-a2.7b and hymba-1.5b, through
``launch.dryrun``'s serving parameters and cache) each attention call
gathers at most the token's query and all-reduces two (B, H) fp32
vectors, and the step's all-gather is the same at S_max 16 and 64.  On
four gloo ranks (1x4) several decode steps give one process's logits and
cache: within 1e-5 in fp32, a position on the first shard (three devices
see no key) and on a shard boundary, hymba's ring window across its
shards; and in bf16 within ``BF16_TOL``.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as sp
from repro_torch.measure.counters import MeshCounter
from repro_torch.models import attention, hybrid
from repro_torch.serve import engine

ROOT = pathlib.Path(__file__).resolve().parents[1]

ARCHS = ("smollm-135m", "qwen2-moe-a2.7b", "hymba-1.5b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B = 4


def _decode_on_fake_mesh(monkeypatch, arch, dims, s_max):
    """One decode step of reduced ``arch`` (at ``pos = s_max - 1``) on a
    fake mesh of ``dims`` under the dry-run's decode rules, as
    ``launch.dryrun`` lowers a decode cell: the step's counter, and for
    each ``_sdpa_grouped`` call the collectives it recorded, the mesh dims
    that shard its cache's sequence, and its query's global and local
    batch and heads."""
    cfg = get_reduced(arch)
    shape = ShapeSpec("decode_shards", s_max, B, "decode")
    calls = []
    with mesh_mod.fake_mesh(dims, mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["decode_32k"])):
            fm = dryrun._fake_mode()
            params = dryrun._serving_params(cfg, mesh, fm)
            with fm:
                cache_abs = sp.abstract_cache(cfg, sp.abstract_params(cfg),
                                              shape)
                cache = sp.attach(cache_abs,
                                  sp.cache_logical_specs(cfg, cache_abs),
                                  mesh)
                dec = sp.decode_input_specs(cfg, shape, mesh)
            counter = MeshCounter(fake_mode=fm)
            counter.hold((params, dec["tokens"], cache))
            real = attention._sdpa_grouped

            def counted(q, k, v, bias, cfg):
                ops = len(counter.collectives)
                out = real(q, k, v, bias, cfg)
                calls.append({"ops": counter.collectives[ops:],
                              "seq": attention._seq_dims(k, v),
                              "q": tuple(q.shape),
                              "rows": out.to_local().numel() // q.shape[3],
                              "itemsize": q.element_size()})
                return out

            from torch.distributed.tensor.experimental import \
                implicit_replication
            step = engine.build_serve_step(cfg)
            with monkeypatch.context() as m:
                m.setattr(attention, "_sdpa_grouped", counted)
                m.setattr(hybrid, "_sdpa_grouped", counted)
                with implicit_replication(), counter, torch.no_grad():
                    step(params, dec["tokens"], cache, dec["pos"])
    return counter, calls


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_device_attends_over_its_own_keys(monkeypatch, arch, mesh):
    """Every layer's attention takes the sharded path, gathers at most the
    one token's query (B x H x dh) and all-reduces exactly two fp32
    vectors of its batch rows x H over each sequence mesh dim: the
    softmax's max and sum.  Before, DTensor's softmax gathered B x H x
    S_max fp32 scores a layer."""
    dims = MESHES[mesh]
    _, calls = _decode_on_fake_mesh(monkeypatch, arch, dims, 16)
    assert len(calls) == get_reduced(arch).n_layers
    for call in calls:
        assert call["seq"], "the cache's sequence is not sharded"
        Bq, _, H, dh = call["q"]
        gathered = sum(op.wire_bytes for op in call["ops"]
                       if op.kind == "all-gather")
        assert gathered <= Bq * H * dh * call["itemsize"], call["ops"]
        reduced = [op for op in call["ops"] if op.kind == "all-reduce"]
        assert len(reduced) == 2 * len(call["seq"]), call["ops"]
        assert all(op.bytes_result == call["rows"] * 4 for op in reduced)
        assert {op.kind for op in call["ops"]} <= {"all-gather",
                                                   "all-reduce"}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_the_decode_gathers_no_more_for_a_longer_cache(monkeypatch, arch,
                                                       mesh):
    """The step's all-gather bytes a device are the same at S_max 16 and
    64, and so is every other collective's.  Before, the scores' gather
    grew with S_max: smollm's on 1x4 read 1,728 and 6,912 B."""
    short, long = (_decode_on_fake_mesh(monkeypatch, arch, MESHES[mesh],
                                        s)[0].summary.by_kind()
                   for s in (16, 64))
    assert "all-gather" not in short or short["all-gather"][1] > 0
    assert short == long


# --- on four gloo ranks ------------------------------------------------------

RANKS = r"""
import json, sys, traceback
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs as sp
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.models import attention, transformer
from repro_torch.serve import engine
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_map

CASES = json.loads(sys.argv[2])
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
on_shards = attention._sdpa_grouped_on_shards
taken = []


def counted(*args):
    taken.append(1)
    return on_shards(*args)


attention._sdpa_grouped_on_shards = counted


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    return float((full(a).float() - b.float()).abs().max()
                 / b.float().abs().max())


def decode_case(mesh, arch, overrides, dtype, B, S_max, positions):
    cfg = get_reduced(arch).replace(compute_dtype=DTYPES[dtype], **overrides)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_lm(cfg, gen, device="cpu")
    cache = engine.init_cache(params, cfg, B, S_max)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen)
                     .to(t.dtype), cache)
    tokens = torch.randint(0, cfg.vocab_size, (len(positions), B, 1),
                           generator=gen)
    rules = dryrun._rules_for(cfg, mesh, SHAPES["decode_32k"])
    with sh.use_sharding(mesh, rules), implicit_replication(), \
            torch.no_grad():
        pm = sh.place_tree(params, sh.specs_to_shardings(
            model_param_specs(cfg), mesh))
        cm = sh.place_tree(cache, sh.specs_to_shardings(
            sp.cache_logical_specs(cfg, cache), mesh))
        want_cache = tree_map(lambda t: t.clone(), cache)
        out = []
        taken.clear()
        for tok, pos in zip(tokens, positions):
            want, _ = transformer.decode_step(params, tok, want_cache, pos,
                                              cfg)
            tm = sh.place(tok, sh.NamedSharding(
                mesh, sh.logical_spec(("batch", None))))
            got, _ = transformer.decode_step(pm, tm, cm, pos, cfg)
            out.append(rel(got, want))
        got_leaves = [full(t) for t in tree_leaves(cm)]
        return {"out": max(out),
                "cache": max(rel(a, b) for a, b in
                             zip(got_leaves, tree_leaves(want_cache))),
                "on_shards": len(taken),
                "layers_steps": cfg.n_layers * len(positions)}


dist.init_process_group("gloo", init_method="env://")
mesh = make_mesh((1, 4), AXES, device="cpu")
results = {}
for name, case in CASES.items():
    try:
        results[name] = decode_case(mesh, case["arch"], case["overrides"],
                                    case["dtype"], *case["at"])
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""

#: reduced smollm made GQA: 3 query heads on one kv head
GQA = {"n_kv_heads": 1}
#: B = 4 rows, a cache of 16 (4 rows a device): positions 0-2 lie on the
#: first shard, where three devices see no key; 3, 4 and 5 cross its
#: boundary.  Hymba's ring of 8 (2 slots a device) takes 0-2 on its first
#: two shards and 9-11 across its second and third with every slot seen.
FIRST, BOUNDARY, RING = [0, 1, 2], [3, 4, 5], [9, 10, 11]
CASES = {
    f"{name}_{where}": {"arch": arch, "overrides": over, "dtype": "float32",
                        "at": [B, 16, at]}
    for name, arch, over in (("smollm_gqa", "smollm-135m", GQA),
                             ("qwen2_moe", "qwen2-moe-a2.7b", {}),
                             ("hymba", "hymba-1.5b", {}))
    for where, at in (("first", FIRST), ("boundary", BOUNDARY))
}
CASES["hymba_ring"] = {"arch": "hymba-1.5b", "overrides": {},
                       "dtype": "float32", "at": [B, 16, RING]}
CASES.update({
    f"{name}_bf16": {"arch": arch, "overrides": over, "dtype": "bfloat16",
                     "at": [B, 16, FIRST + BOUNDARY]}
    for name, arch, over in (("smollm_gqa", "smollm-135m", GQA),
                             ("hymba", "hymba-1.5b", {}))
})

FP32_TOL = 1e-5
#: bf16: the six steps' logits and the cache against one process's,
#: relative to the largest entry: ten units of bf16 roundoff (2^-8 each).
#: They read 0.0176 (smollm) and 0.0267 (hymba), as they did when the
#: scores were gathered and softmaxed whole: the gap is the sharded
#: products' bf16 partial sums, which one process adds in its contraction,
#: carried through the layers that follow.
BF16_TOL = 4e-2


@pytest.fixture(scope="module")
def on_four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    script, out = tmp / "ranks.py", tmp / "results.json"
    script.write_text(RANKS)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "4", "--master_addr", "127.0.0.1", "--master_port", port,
         str(script), str(out), json.dumps(CASES)], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_on_the_shards_gives_one_process_values(case, on_four_ranks):
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert res["on_shards"] == res["layers_steps"]   # every layer, each step
    tol = FP32_TOL if CASES[case]["dtype"] == "float32" else BF16_TOL
    assert res["out"] <= tol and res["cache"] <= tol, res
