"""The decode cache's row write and the MoE's two-pod grouping under a mesh:
each device writes and routes its own share, and the values are one
process's.

``attention.write_row`` writes a decode step's new k and v row into the
one shard of the cache whose sequence range holds its slot, the row laid
out as the cache's rows first (one row moved, never the cache).  On a fake
2x2 mesh under the dry-run's decode rules (``kv_seq`` and the kv heads
both on the model axis) the write records no collective beyond that row,
and none at all for a row already laid out.  On four gloo ranks three
decode steps across the cache's shard boundary give one process's logits
and cache: reduced qwen2-moe, and reduced hymba, whose ring buffers take
the same write and whose Mamba state steps on each device's (batch,
heads) shard (``ssd._step_on_shards``; torch 2.11 refused DTensor's own
step there).

``moe._group_layout``'s case 3: where one mesh axis splits the sequence
into runs shorter than a group and the data shard's rows hold as many
groups as that axis has devices (the two-pod train cells: 8 rows of two
groups on 16 model devices), each device takes one group's runs from its
peers by one all-to-all of uneven splits (``moe._exchange``).  On fake
2x4 and 1x4 meshes each device routes its own tokens once; on four gloo
ranks (1x4) the output, the aux loss and every grad are one process's.
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
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as sp
from repro_torch.measure.counters import MeshCounter
from repro_torch.models import attention, moe
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]

B, S_MAX = 4, 16
CACHE_AXES = ("batch", "kv_seq", "kv_heads", "head_dim")


def _attn_cfg():
    """Reduced qwen2-moe in fp32: 4 heads and 4 kv heads, which divide the
    model axis, so the decode rules shard the heads and the cache's
    sequence on it."""
    return get_reduced("qwen2-moe-a2.7b").replace(compute_dtype=torch.float32)


def _writes_on_fake_mesh(monkeypatch, pos, s_max=S_MAX):
    """One layer's ``decode_attention`` at ``pos`` on a fake 2x2 mesh under
    the dry-run's decode rules, its cache of ``s_max`` rows: for each
    ``write_row`` call the collectives and the bytes (B_M) it recorded;
    and the row's bytes."""
    cfg = _attn_cfg()
    K, dh = cfg.n_kv_heads, cfg.dh
    calls = []
    with mesh_mod.fake_mesh((2, 2), mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["decode_32k"])):
            fm = dryrun._fake_mode()
            with fm:
                p = sp.attach(sp.abstract_params(cfg)["blocks"][0]["attn"],
                              model_param_specs(cfg)["blocks"][0]["attn"],
                              mesh)
                x = sp._laid_out((B, 1, cfg.d_model), torch.float32, mesh,
                                 ("batch", None, "embed"))
                cache = {k: sp._laid_out((B, s_max, K, dh), torch.float32,
                                         mesh, CACHE_AXES) for k in "kv"}
            assert cache["k"].placements == (sh.Shard(0), sh.Shard(1))
            counter = MeshCounter(fake_mode=fm)
            counter.hold((p, x, cache))
            real = attention.write_row

            def counted(buf, row, slot):
                ops, moved = len(counter.collectives), counter.bytes
                real(buf, row, slot)
                calls.append((counter.collectives[ops:],
                              counter.bytes - moved))

            from torch.distributed.tensor.experimental import \
                implicit_replication
            with monkeypatch.context() as m:
                m.setattr(attention, "write_row", counted)
                with implicit_replication(), counter, torch.no_grad():
                    attention.decode_attention(p, x, cache, pos, cfg)
    return calls, B * K * dh * 4


@pytest.mark.parametrize("pos", [3, 12])
def test_the_decode_write_moves_one_row_not_the_cache(monkeypatch, pos):
    """k's and v's writes each record at most one all-gather of the row
    (its kv heads, sharded by the projection, made whole on the model
    axis), whether this device's shard holds ``pos`` (3) or not (12); the
    select over the whole sequence that the write was before gathered the
    cache on torch 2.11 (97.02 GB a device at qwen2-moe decode_32k 16x16).
    """
    calls, row = _writes_on_fake_mesh(monkeypatch, pos)
    assert len(calls) == 2
    for ops, _ in calls:
        assert all(op.kind == "all-gather" for op in ops), ops
        assert sum(op.wire_bytes for op in ops) <= row


def test_the_decode_write_reads_no_more_for_a_longer_cache(monkeypatch):
    """The bytes the writes move (B_M) are the row's whatever the cache's
    length: 4,352 a write at 16 and at 64 rows.  The select read and wrote
    each device's whole shard of the cache: 24,104 and 86,432 bytes."""
    short, long = (_writes_on_fake_mesh(monkeypatch, 3, s)[0]
                   for s in (16, 64))
    assert [b for _, b in short] == [b for _, b in long]


def test_a_row_laid_out_as_the_cache_writes_with_no_collective():
    cfg = _attn_cfg()
    K, dh = cfg.n_kv_heads, cfg.dh
    with mesh_mod.fake_mesh((2, 2), mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["decode_32k"])):
            fm = dryrun._fake_mode()
            with fm:
                buf = sp._laid_out((B, S_MAX, K, dh), torch.float32, mesh,
                                   CACHE_AXES)
                row = sp._laid_out((B, 1, K, dh), torch.float32, mesh,
                                   ("batch", None, None, None))
            counter = MeshCounter(fake_mode=fm)
            counter.hold((buf, row))
            with counter:
                for slot in (0, 7, 8, 15):
                    attention.write_row(buf, row, slot)
    assert counter.collectives == []


# --- the MoE's two-pod grouping ----------------------------------------------

def _moe_cfg(**overrides):
    return get_reduced("qwen2-moe-a2.7b").replace(
        compute_dtype=torch.float32, **overrides)


def _lower_moe(dims, Bm, S, overrides):
    """The MoE layer's forward and backward at (Bm, S) on a fake mesh of
    ``dims`` under the dry-run's train rules: the per-device counts."""
    cfg = _moe_cfg(**overrides)

    def step(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out, aux = moe.apply_moe(tree_unflatten(p, leaves), x, cfg)
        return torch.autograd.grad(out.sum() + aux, leaves + [x])

    with mesh_mod.fake_mesh(dims, mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["train_4k"])):
            fm = dryrun._fake_mode()
            with fm:
                p = sp.attach(sp.abstract_params(cfg)["blocks"][0]["moe"],
                              model_param_specs(cfg)["blocks"][0]["moe"],
                              mesh)
                x = sp._laid_out((Bm, S, cfg.d_model), torch.float32, mesh,
                                 ("batch", "seq", "embed"))
            layout = moe._group_layout(x, overrides["moe_group_tokens"])
            return dryrun._run(step, (p, x), fm, 0), layout


#: (mesh, (B, S), groups of, the exchange's mesh axis)
ONE_GROUP_A_DEVICE = {
    # 3 rows a data shard, 4 tokens of each a device: no layout with whole
    # groups reaches the model axis without the exchange
    "2x4_exchange": ((2, 4), (6, 16), 12, 1),
    "1x4_exchange": ((1, 4), (2, 16), 8, 1),
    # the rows take the model axis and the sequence the data axis: whole
    # groups of 8 on each device with no exchange
    "2x4_whole": ((2, 4), (4, 16), 8, None),
}


@pytest.mark.parametrize("name", sorted(ONE_GROUP_A_DEVICE))
def test_each_device_routes_its_own_groups_once(name):
    """Per-device F x N / F(1 device) within 0.99-1.05.  Before case 3 the
    two exchange cases read 1.2753 (2x4) and 1.2252 (1x4): ``_group_layout``
    kept the model axis replicated and each of its devices routed its data
    shard's groups whole; the whole-groups case read 1.0000 then too.  The
    exchange's all-to-all is what the repair costs."""
    dims, (Bm, S), Tg, axis = ONE_GROUP_A_DEVICE[name]
    over = {"moe_group_tokens": Tg}
    (one, _), (many, layout) = (_lower_moe(d, Bm, S, over)
                                for d in ((1, 1), dims))
    place, grouped, swap = layout
    assert swap == axis
    assert all(p == sh.Shard(0) for n, p in zip(dims, grouped) if n > 1)
    assert many.wire_bytes_by_kind["all-to-all"] > 0
    ratio = many.flops * dims[0] * dims[1] / one.flops
    assert 0.99 <= ratio <= 1.05, ratio


def test_the_layouts_with_whole_groups_and_no_exchange_are_kept():
    """Where whole groups need no exchange (the one-pod cells: a data
    shard's batch takes the model axis too) case 3 does not win, though it
    splits the tokens over as many devices."""
    with mesh_mod.fake_mesh((2, 2), mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, {"seq": "model"}):
            fm = dryrun._fake_mode()
            with fm:
                x = sp._laid_out((8, 32, 16), torch.float32, mesh,
                                 ("batch", "seq", "embed"))
            assert moe._group_layout(x, 32) == (
                (sh.Shard(0), sh.Shard(0)), (sh.Shard(0), sh.Shard(0)), None)
            assert moe._group_layout(x, 16)[2] is None


# --- on four gloo ranks ------------------------------------------------------

RANKS = r"""
import json, os, sys, traceback
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs as sp
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.models import moe, transformer
from repro_torch.serve import engine
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CASES = json.loads(sys.argv[2])


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    return float((full(a) - b).abs().max() / b.abs().max())


seen = []
route_groups = moe._route_groups


def recorded(*args, **kwargs):
    dispatch, combine, aux = route_groups(*args, **kwargs)
    seen.append(full(dispatch).detach().clone())
    return dispatch, combine, aux


moe._route_groups = recorded


def decode_case(mesh, arch, B, S_max, positions):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_lm(cfg, gen, device="cpu")
    cache = engine.init_cache(params, cfg, B, S_max)
    cache = tree_map(lambda t: torch.randn(t.shape, generator=gen), cache)
    tokens = torch.randint(0, cfg.vocab_size, (len(positions), B, 1),
                           generator=gen)
    rules = dryrun._rules_for(cfg, mesh, SHAPES["decode_32k"])
    with sh.use_sharding(mesh, rules), implicit_replication(), \
            torch.no_grad():
        pm = sh.place_tree(params, sh.specs_to_shardings(
            model_param_specs(cfg), mesh))
        cm = sh.place_tree(cache, sh.specs_to_shardings(
            sp.cache_logical_specs(cfg, cache), mesh))
        sharded = [t.placements for t in tree_leaves(cm)
                   if isinstance(t, DTensor) and t.ndim >= 4
                   and any(p == sh.Shard(t.ndim - 3) for p in t.placements)]
        want_cache = tree_map(lambda t: t.clone(), cache)
        out, logits = [], []
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
                "seq_sharded": len(sharded)}


def moe_case(mesh, overrides, B, S):
    cfg = get_reduced("qwen2-moe-a2.7b").replace(compute_dtype=torch.float32,
                                                 **overrides)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(cfg, gen, device="cpu")
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    w = torch.randn((B, S, cfg.d_model), generator=gen)

    def grads(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out, aux = moe.apply_moe(tree_unflatten(p, leaves), x, cfg)
        loss = (full(out) * w).sum() + full(aux)
        g = torch.autograd.grad(loss, leaves + [x])
        return full(out).detach(), float(full(aux)), [full(t) for t in g]

    rules = dryrun._rules_for(cfg, mesh, SHAPES["train_4k"])
    with sh.use_sharding(mesh, rules), implicit_replication():
        pm = sh.place_tree(p, sh.specs_to_shardings(moe.moe_specs(cfg), mesh))
        xm = sh.place(x, sh.NamedSharding(
            mesh, sh.logical_spec(("batch", "seq", "embed"))))
        swap = moe._group_layout(xm, cfg.moe_group_tokens)[2]
        seen.clear()
        want_out, want_aux, want = grads(p, x)
        want_slots = list(seen)
        seen.clear()
        got_out, got_aux, got = grads(pm, xm)
    return {"out": rel(got_out, want_out),
            "aux": abs(got_aux - want_aux) / abs(want_aux),
            "grads": [rel(a, b) for a, b in zip(got, want)],
            "slots_equal": (len(seen) == len(want_slots) == 1
                            and torch.equal(seen[0], want_slots[0])),
            "kept": float(want_slots[0].sum()),
            "chosen": B * S * cfg.moe_top_k,
            "exchange_axis": swap}


dist.init_process_group("gloo", init_method="env://")
results = {}
meshes = {}
for name, case in CASES.items():
    dims = tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = make_mesh(dims, AXES, device="cpu")
    try:
        if case["kind"] == "decode":
            results[name] = decode_case(meshes[dims], case["arch"],
                                        *case["at"])
        else:
            results[name] = moe_case(meshes[dims], case["overrides"],
                                     *case["at"])
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""

#: the gloo cases, each on four ranks
CASES = {
    # a cache of 16 rows, 8 on each model device: steps at 7, 8 and 9
    # write the last row of one shard, then the first two of the next
    "decode_qwen2_moe": {"kind": "decode", "mesh": [2, 2],
                         "arch": "qwen2-moe-a2.7b", "at": [4, 16, [7, 8, 9]]},
    # hymba's global layers write at pos, its local ones into a ring of 8
    # at pos % 8 (4 a device): 10, 11 and 12 cross the ring's shards
    "decode_hymba": {"kind": "decode", "mesh": [2, 2], "arch": "hymba-1.5b",
                     "at": [4, 16, [10, 11, 12]]},
    # (2, 16) on 1x4 in groups of 8: each device holds 4 tokens of each row
    # and takes one whole group from two peers (case 3); capacity 1.0 so
    # that choices drop past their expert's slots
    "moe_exchange": {"kind": "moe", "mesh": [1, 4],
                     "overrides": {"moe_group_tokens": 8,
                                   "capacity_factor": 1.0},
                     "at": [2, 16]},
    # (3, 16) in groups of 12: a group crosses a row's end, so a device
    # gets runs of two rows from three peers and puts them in token order
    "moe_exchange_rows": {"kind": "moe", "mesh": [1, 4],
                          "overrides": {"moe_group_tokens": 12,
                                        "capacity_factor": 1.0},
                          "at": [3, 16]},
}


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


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "decode"))
def test_decode_steps_across_the_shard_boundary_give_one_process_values(
        case, on_four_ranks):
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert res["seq_sharded"] > 0          # the cache's sequence is split
    assert res["out"] <= 1e-5 and res["cache"] <= 1e-5, res


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "moe"))
def test_the_exchanged_moe_gives_one_process_values(case, on_four_ranks):
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert res["exchange_axis"] == 1
    assert res["out"] <= 1e-5 and res["aux"] <= 1e-5, res
    assert res["grads"] and max(res["grads"]) <= 1e-5, res["grads"]
    assert res["slots_equal"]
    assert 0 < res["kept"] < res["chosen"]      # some choices dropped
