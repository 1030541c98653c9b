"""The MoE and the sLSTM under a mesh: each device does its share of the
work once, and the values are one process's.

``moe.apply_moe`` routes each dispatch group once across the mesh: where a
device's shard holds whole groups (case 1) the groups axis is sharded over
every mesh axis that splits the tokens, the batch taking the sequence's
axis by one all-to-all; where a group holds more tokens than a device
(case 2: a short batch, decode) each device routes its own run of the
group's tokens, its slots offset by the earlier runs' counts.
``ssm.apply_slstm`` runs the recurrence on each device's batch rows and
channels, the sequence moved once a layer, never once a step.

On a fake 2x2 mesh (``launch.mesh.fake_mesh``, ``measure.counters``'s
``MeshCounter`` through ``launch.dryrun._run``) each layer's forward and
backward count F x 4 / F(1x1) near 1 and all-gather bytes linear in the
sequence.  On four gloo ranks (one ``torchrun`` subprocess for every
case) the outputs and grads are one process's within 1e-5 of their
largest entry, and the MoE's dispatch tensor (each kept choice's slot) is
one process's exactly.
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
from repro_torch.models import moe, ssm
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the layers counted on the fake mesh: (arch, overrides, the block whose
#: layer runs, the layer's key in it)
LAYERS = {
    "moe_case1": ("qwen2-moe-a2.7b", {"moe_group_tokens": 32}, 0, "moe"),
    "moe_case2": ("qwen2-moe-a2.7b", {}, 0, "moe"),
    "slstm": ("xlstm-125m", {}, 1, "slstm"),
}


def _layer_cfg(name):
    arch, overrides, _, _ = LAYERS[name]
    return get_reduced(arch).replace(compute_dtype=torch.float32,
                                     **overrides)


def _lower(name, dims, B, S):
    """The layer's forward and backward at (B, S) on a fake mesh of
    ``dims``, under the dry-run's train rules: the per-device counts."""
    _, _, block, key = LAYERS[name]
    cfg = _layer_cfg(name)
    apply = moe.apply_moe if key == "moe" else ssm.apply_slstm

    def step(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out = apply(tree_unflatten(p, leaves), x, cfg)
        loss = out[0].sum() + out[1] if key == "moe" else out.sum()
        return torch.autograd.grad(loss, leaves + [x])

    with mesh_mod.fake_mesh(dims, mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["train_4k"])):
            fm = dryrun._fake_mode()
            with fm:
                p = sp.attach(sp.abstract_params(cfg)["blocks"][block][key],
                              model_param_specs(cfg)["blocks"][block][key],
                              mesh)
                x = sp._laid_out((B, S, cfg.d_model), torch.float32, mesh,
                                 ("batch", "seq", "embed"))
            return dryrun._run(step, (p, x), fm, 0)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_each_device_does_its_share_of_the_work_once(name):
    """Per-device F x 4 / F(1 device) at (8, 32) on 2x2: at most 1.05 (the
    MoE read 2.6 and 1.17 when every model-axis device routed, dispatched
    and combined its data shard's groups whole; the sLSTM block 1.22 when
    its post-FFN ran through DTensor's own matmul, whose backward repeated
    work)."""
    one, four = (_lower(name, dims, 8, 32) for dims in ((1, 1), (2, 2)))
    assert not any(one.wire_bytes_by_kind.values())
    ratio = four.flops * 4 / one.flops
    assert 0.99 <= ratio <= 1.05, ratio


@pytest.mark.parametrize("name", ["moe_case2", "slstm"])
def test_all_gather_bytes_grow_with_the_sequence_not_its_square(name):
    """All-gather bytes a device at S = 32 and 64 on 2x2 within 2.2x of
    each other (the sLSTM's grew 3.3x when each time step gathered the
    sequence, the MoE's 2.5x when its groups were gathered whole)."""
    short, long = (_lower(name, (2, 2), 8, S).wire_bytes_by_kind
                   for S in (32, 64))
    assert short.get("all-gather", 0.0) > 0
    assert long["all-gather"] <= 2.2 * short["all-gather"]


RANKS = r"""
import json, os, sys
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AXES, open_mesh
from repro_torch.models import moe, ssm
from repro_torch.tree import tree_leaves, tree_unflatten

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


def draw(cfg, kind, B, S):
    gen = torch.Generator().manual_seed(0)
    if kind == "moe":
        p = moe.init_moe(cfg, gen, device="cpu")
    else:
        p = ssm.init_slstm(cfg, gen, device="cpu")
        for k in ("r_diag", "b"):
            p[k] = torch.randn(p[k].shape, generator=gen)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    w = torch.randn((B, S, cfg.d_model), generator=gen)
    return p, x, w


def grads(cfg, kind, p, x, w):
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
    x = x.detach().requires_grad_(True)
    params = tree_unflatten(p, leaves)
    if kind == "moe":
        out, aux = moe.apply_moe(params, x, cfg)
        loss = (full(out) * w).sum() + full(aux)
    else:
        out = ssm.apply_slstm(params, x, cfg)
        loss = (full(out) * w).sum()
    g = torch.autograd.grad(loss, leaves + [x])
    return full(out).detach(), [full(t) for t in g]


def decode(cfg, p, x, state):
    ys = []
    for t in range(x.shape[1]):
        y, state = ssm.decode_slstm(p, x[:, t:t + 1], state, cfg)
        ys.append(full(y))
    return ys, state


results = {}
with open_mesh((2, 2), AXES, "cpu") as mesh:
    for name, (arch, overrides, kind, (B, S)) in CASES.items():
        cfg = get_reduced(arch).replace(compute_dtype=torch.float32,
                                        **overrides)
        p, x, w = draw(cfg, kind, B, S)
        specs = (moe.moe_specs(cfg) if kind == "moe"
                 else ssm.slstm_specs(cfg))
        rules = dryrun._rules_for(cfg, mesh, SHAPES["train_4k"])
        with sh.use_sharding(mesh, rules), implicit_replication():
            pm = sh.place_tree(p, sh.specs_to_shardings(specs, mesh))
            xm = sh.place(x, sh.NamedSharding(
                mesh, sh.logical_spec(("batch", "seq", "embed"))))
            if kind == "decode":
                state = ssm.init_slstm_state(cfg, B, device="cpu")
                want, want_state = decode(cfg, p, x, state)
                row = sh.NamedSharding(mesh, sh.logical_spec(("batch", None)))
                placed = {k: sh.place(v, row) for k, v in state.items()}
                got, got_state = decode(cfg, pm, xm, placed)
                results[name] = {
                    "out": max(rel(a, b) for a, b in zip(got, want)),
                    "state": max(rel(got_state[k], want_state[k])
                                 for k in want_state),
                    "layout_kept": all(
                        got_state[k].placements == placed[k].placements
                        for k in placed)}
                continue
            seen.clear()
            want_out, want = grads(cfg, kind, p, x, w)
            want_slots = list(seen)
            seen.clear()
            got_out, got = grads(cfg, kind, pm, xm, w)
            res = {"out": rel(got_out, want_out),
                   "grads": [rel(a, b) for a, b in zip(got, want)]}
            if kind == "moe":
                C = want_slots[0].shape[-1]
                res["slots_equal"] = (
                    len(seen) == len(want_slots) == 1
                    and torch.equal(seen[0], want_slots[0]))
                res["kept"] = float(want_slots[0].sum())
                res["chosen"] = B * S * cfg.moe_top_k
            results[name] = res
if os.environ["RANK"] == "0":
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
"""

#: the gloo cases: (arch, overrides, layer, (B, S)), each on 2x2 under the
#: dry-run's train rules (the batch on the data axis, the sequence on the
#: model axis); capacity 1.0 so that choices drop past their expert's slots
CASES = {
    # 8 experts on the model axis (expert parallelism); groups of 16: each
    # device's shard takes two whole rows, one group each (case 1)
    "moe_case1_ep": ("qwen2-moe-a2.7b",
                     {"moe_group_tokens": 16, "capacity_factor": 1.0},
                     "moe", (8, 16)),
    # one group of 128 tokens, a quarter on each device (case 2)
    "moe_case2_ep": ("qwen2-moe-a2.7b", {"capacity_factor": 1.0}, "moe",
                     (8, 16)),
    # 3 experts on 2: each expert's hidden axis sharded instead
    "moe_case1_tp": ("qwen2-moe-a2.7b",
                     {"moe_group_tokens": 16, "capacity_factor": 1.0,
                      "n_experts": 3}, "moe", (8, 16)),
    "moe_case2_tp": ("qwen2-moe-a2.7b",
                     {"capacity_factor": 1.0, "n_experts": 3}, "moe",
                     (8, 16)),
    # one token a row, as decode routes: a group of 8 over four devices
    "moe_decode": ("qwen2-moe-a2.7b", {"capacity_factor": 1.0}, "moe",
                   (8, 1)),
    # the recurrence on each device's 24 of 48 channels
    "slstm": ("xlstm-125m", {}, "slstm", (4, 16)),
    # 45 channels do not split in two: the sequence gathered once
    "slstm_gathered": ("xlstm-125m", {"d_model": 45}, "slstm", (4, 16)),
    # three decode steps from a state laid out on the batch
    "slstm_decode": ("xlstm-125m", {}, "decode", (4, 3)),
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_four_ranks_give_one_process_values(case, on_four_ranks):
    res = on_four_ranks[case]
    assert res["out"] <= 1e-5
    if CASES[case][2] == "decode":
        assert res["state"] <= 1e-5 and res["layout_kept"]
        return
    assert res["grads"] and max(res["grads"]) <= 1e-5, res["grads"]
    if CASES[case][2] == "moe":
        assert res["slots_equal"]
        assert 0 < res["kept"] < res["chosen"]      # some choices dropped
