"""The SSD recurrence on each device's own run of chunks, under a mesh.

Where a mesh dim shards the sequence of ``chunked_linear_recurrence``'s
inputs (or holds them as partial sums, as the mLSTM's projections leave
q, k and v) and each device's run of T / n tokens is whole chunks, each
device runs its own chunks once (``ssd._on_sequence_shards``) and only
the runs' summaries cross the sequence's devices (``ssd._exclusive_prefix``,
a doubling scan of ceil(log2 n) rounds and one shift, each send an
all-to-all of one peer).  Where the run is not whole chunks the call keeps
``ssd._on_shards`` (each device the whole sequence).

On fake 1x4 and 2x2 meshes under the dry-run's train rules the reduced
mLSTM (xlstm-125m) and Mamba (hymba-1.5b) layers count F x 4 / F(1x1) at
most 1.02 in forward and backward (``_on_shards``, every model-axis device
computing the whole sequence's scores, reads 1.02-1.17), every call takes
the sequence path, and the exchange sends the same bytes at S = 64 and
128.  On four gloo ranks (one ``torchrun`` subprocess for every case) both
layers on 1x4 and 2x2, one chunk a device and several, with decays near 0
and near 1, and direct calls whose loss reads the final state, give one
process's output, grads and final state within 1e-5 of their largest
entry; runs that are not whole chunks take the fallback and match too.
"""
import json
import math
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
from repro_torch.models import mamba, ssd, ssm
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the layers counted: (arch, the block whose layer runs, its key, apply)
LAYERS = {
    "mlstm": ("xlstm-125m", 0, "mlstm", ssm.apply_mlstm),
    "mamba": ("hymba-1.5b", 0, "mamba", mamba.apply_mamba),
}


def _paths(monkeypatch):
    """Which DTensor path each ``chunked_linear_recurrence`` call took, and
    the shapes of the summaries each exchange sent."""
    taken, sent = [], []
    for name in ("_on_sequence_shards", "_on_shards"):
        def spy(*args, _f=getattr(ssd, name), _n=name, **kwargs):
            taken.append(_n)
            return _f(*args, **kwargs)
        monkeypatch.setattr(ssd, name, spy)

    def exchange(a, parts, mesh, dim, _f=ssd._exclusive_prefix):
        sent.append((tuple(a.shape), [tuple(p.shape) for p in parts],
                     mesh.size(dim)))
        return _f(a, parts, mesh, dim)
    monkeypatch.setattr(ssd, "_exclusive_prefix", exchange)
    return taken, sent


def _lower(name, dims, B, S, chunk):
    """The layer's forward and backward at (B, S) on a fake mesh of
    ``dims``, under the dry-run's train rules: the per-device counts."""
    arch, block, key, apply = LAYERS[name]
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32,
                                    ssm_chunk=chunk)

    def step(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out = apply(tree_unflatten(p, leaves), x, cfg)
        return torch.autograd.grad(out.sum(), leaves + [x])

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


#: (mesh, ssm_chunk, S): each device's run whole chunks (on 1x4 a chunk
#: of 32 needs S = 128: at S = 64 each run is half a chunk, the fallback)
COUNTED = [((1, 4), 16, 64), ((1, 4), 32, 128), ((2, 2), 16, 64),
           ((2, 2), 32, 64)]


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("dims,chunk,S", COUNTED)
def test_each_device_runs_its_own_chunks_once(name, dims, chunk, S,
                                              monkeypatch):
    """F x 4 / F(1 device) at (8, S) at most 1.02 (``_on_shards`` reads
    1.0208-1.1658: the scores, decay matrix and normaliser of the whole
    sequence on every model-axis device), and every call on the mesh takes
    the sequence path."""
    taken, _ = _paths(monkeypatch)
    one = _lower(name, (1, 1), 8, S, chunk)
    assert taken == ["_on_shards"]      # no mesh dim of two devices
    taken.clear()
    four = _lower(name, dims, 8, S, chunk)
    assert not any(one.wire_bytes_by_kind.values())
    assert taken == ["_on_sequence_shards"]
    ratio = four.flops * 4 / one.flops
    assert 0.99 <= ratio <= 1.02, ratio


def _exchange_bytes(a, parts, n):
    """What one device sends in ``_exclusive_prefix``'s forward and its
    backward's reverse sends: (a, M, n) in each of ceil(log2 n) rounds and
    (M, n) in the shift, fp32, each way."""
    per = math.prod(a) + sum(math.prod(p) for p in parts)
    rest = sum(math.prod(p) for p in parts)
    return 2 * 4 * (math.ceil(math.log2(n)) * per + rest)


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("normalize", [True, False])
def test_the_exchange_sends_ceil_log2_n_plus_one_buffers_each_way(
        n, normalize):
    """``_exclusive_prefix`` alone on a fake 1 x n mesh, forward and
    backward: all-to-all only, of the bytes ``_exchange_bytes`` gives."""
    B, H, dk, dv = 2, 3, 5, 7
    shapes = [(B, H, dk, dv), (B, H, dk)] if normalize else [(B, H, dk, dv)]

    def step(a, *parts):
        leaves = [t.detach().requires_grad_(True) for t in (a,) + parts]
        out = ssd._exclusive_prefix(leaves[0], leaves[1:], mesh, 1)
        return torch.autograd.grad(sum(o.sum() for o in out), leaves)

    with mesh_mod.fake_mesh((1, n), mesh_mod.AXES) as mesh:
        fm = dryrun._fake_mode()
        with fm:
            args = [torch.ones((B, H))] + [torch.ones(s) for s in shapes]
        low = dryrun._run(step, args, fm, 0)
    wire = {k: v for k, v in low.wire_bytes_by_kind.items() if v}
    assert wire == {"all-to-all": _exchange_bytes((B, H), shapes, n)}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_the_exchange_is_independent_of_the_sequence(name, monkeypatch):
    """The summaries a device sends on 2x2 at S = 64 and 128 (chunk 16):
    the same shapes, so the same bytes, which the layer's all-to-all
    holds at either S."""
    _, sent = _paths(monkeypatch)
    lows = [_lower(name, (2, 2), 8, S, 16) for S in (64, 128)]
    assert len(sent) == 2 and sent[0] == sent[1]
    a, parts, n = sent[0]
    assert n == 2 and a == (4, get_reduced(LAYERS[name][0]).n_heads)
    for low in lows:
        assert _exchange_bytes(a, parts, n) <= \
            low.wire_bytes_by_kind["all-to-all"]


RANKS = r"""
import json, os, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AXES, open_mesh
from repro_torch.models import mamba, ssd, ssm
from repro_torch.tree import tree_leaves, tree_unflatten

CASES = json.loads(sys.argv[2])
taken = []
for name in ("_on_sequence_shards", "_on_shards"):
    def spy(*args, _f=getattr(ssd, name), _n=name, **kwargs):
        taken.append(_n)
        return _f(*args, **kwargs)
    setattr(ssd, name, spy)

#: the forget-gate bias (mLSTM) or A_log (Mamba) that puts the decays
#: near 0 or near 1
DECAY = {"mlstm": {"low": -12.0, "high": 12.0},
         "mamba": {"low": 4.0, "high": -12.0}}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    return float((full(a) - b).abs().max() / b.abs().max())


def layer(kind, cfg, decay, B, S):
    gen = torch.Generator().manual_seed(0)
    if kind == "mlstm":
        p, specs, apply = (ssm.init_mlstm(cfg, gen, device="cpu"),
                           ssm.mlstm_specs(cfg), ssm.apply_mlstm)
        if decay:
            p["b_if"][cfg.n_heads:] = DECAY[kind][decay]
    else:
        p, specs, apply = (mamba.init_mamba(cfg, gen, device="cpu"),
                           mamba.mamba_specs(cfg), mamba.apply_mamba)
        if decay:
            p["A_log"].fill_(DECAY[kind][decay])
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    w = torch.randn((B, S, cfg.d_model), generator=gen)
    return p, specs, apply, x, w


def layer_grads(apply, cfg, p, x, w):
    leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
    x = x.detach().requires_grad_(True)
    out = apply(tree_unflatten(p, leaves), x, cfg)
    g = torch.autograd.grad((full(out) * w).sum(), leaves + [x])
    return full(out).detach(), [full(t) for t in g]


def direct(mesh, B, S, chunk, normalize, decay):
    gen = torch.Generator().manual_seed(1)
    H, dk, dv = 2, 6, 5
    q, k = (0.5 * torch.randn((B, S, H, dk), generator=gen) for _ in "qk")
    v = torch.randn((B, S, H, dv), generator=gen)
    lo, hi = {"low": (1e-6, 1e-3), "high": (1 - 1e-5, 1.0),
              None: (0.5, 0.99)}[decay]
    ld = torch.log(lo + (hi - lo) * torch.rand((B, S, H), generator=gen))
    ws = [torch.randn(s, generator=gen)
          for s in ((B, S, H, dv), (B, H, dk, dv), (B, H, dk))]

    def run(args):
        y, (M, n) = ssd.chunked_linear_recurrence(
            *args, chunk=chunk, normalize=normalize)
        out = [full(y), full(M), full(n)]
        loss = sum((o * w).sum() for o, w in zip(out, ws))
        return [o.detach() for o in out], [full(g) for g in
                                           torch.autograd.grad(loss, args)]

    args = [t.requires_grad_(True) for t in (q, k, v, ld)]
    want = run(args)
    place = [Shard(0) if mesh.size(0) > 1 else Replicate(), Shard(1)]
    got = run([distribute_tensor(t.detach(), mesh, place).requires_grad_(True)
               for t in (q, k, v, ld)])
    return got, want


results = {}
dist.init_process_group("gloo", init_method="env://")
for dims in ([1, 4], [2, 2]):
    with open_mesh(tuple(dims), AXES, "cpu") as mesh:
        for name, (kind, mesh_dims, (B, S), chunk, decay, extra) in \
                CASES.items():
            if mesh_dims != dims:
                continue
            taken.clear()
            if kind == "direct":
                (out, grads), (want_out, want) = direct(
                    mesh, B, S, chunk, extra, decay)
                results[name] = {"out": rel(out[0], want_out[0]),
                                 "state": max(rel(a, b) for a, b in
                                              zip(out[1:], want_out[1:])),
                                 "grads": [rel(a, b)
                                           for a, b in zip(grads, want)],
                                 "taken": list(taken)}
                continue
            arch = {"mlstm": "xlstm-125m", "mamba": "hymba-1.5b"}[kind]
            cfg = get_reduced(arch).replace(compute_dtype=torch.float32,
                                            ssm_chunk=chunk)
            p, specs, apply, x, w = layer(kind, cfg, decay, B, S)
            want_out, want = layer_grads(apply, cfg, p, x, w)
            rules = dryrun._rules_for(cfg, mesh, SHAPES["train_4k"])
            with sh.use_sharding(mesh, rules), implicit_replication():
                pm = sh.place_tree(p, sh.specs_to_shardings(specs, mesh))
                xm = sh.place(x, sh.NamedSharding(
                    mesh, sh.logical_spec(("batch", "seq", "embed"))))
                got_out, got = layer_grads(apply, cfg, pm, xm, w)
            results[name] = {"out": rel(got_out, want_out),
                             "grads": [rel(a, b) for a, b in zip(got, want)],
                             "taken": list(taken)}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""


def _cases():
    """name -> (layer or "direct", mesh, (B, S), chunk, decay, normalize):
    the layers one chunk a device (S = 4 x 8 on 1x4, 2 x 8 on 2x2) and
    several (S = 64, chunk 8: 2 and 4 a device), the latter also with
    every decay near 0 and near 1; direct calls with the final state in
    the loss; runs not whole chunks (S = 48, chunk 16 on 1x4), which keep
    ``_on_shards``."""
    cases = {}
    for kind in ("mlstm", "mamba"):
        for dims, B, one in (([1, 4], 2, 32), ([2, 2], 4, 16)):
            tag = f"{kind}_{dims[0]}x{dims[1]}"
            cases[f"{tag}_one_chunk"] = (kind, dims, (B, one), 8, None, None)
            for decay in (None, "low", "high"):
                cases[f"{tag}_chunks_{decay or 'mid'}"] = (
                    kind, dims, (B, 64), 8, decay, None)
        cases[f"{kind}_1x4_not_whole_chunks"] = (kind, [1, 4], (2, 48), 16,
                                                 None, None)
    for dims, B in (([1, 4], 2), ([2, 2], 4)):
        for normalize in (True, False):
            for decay in (None, "low", "high"):
                cases[f"direct_{dims[0]}x{dims[1]}_norm{int(normalize)}_"
                      f"{decay or 'mid'}"] = ("direct", dims, (B, 64), 8,
                                              decay, normalize)
        cases[f"direct_{dims[0]}x{dims[1]}_one_chunk"] = (
            "direct", dims, (B, 32 if dims[1] == 4 else 16), 8, None, True)
    cases["direct_1x4_not_whole_chunks"] = ("direct", [1, 4], (2, 48), 16,
                                            None, True)
    return cases


CASES = _cases()


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
    whole = "not_whole_chunks" not in case
    assert res["taken"] and set(res["taken"]) == {
        "_on_sequence_shards" if whole else "_on_shards"}, res["taken"]
    assert res["out"] <= 1e-5
    assert res["grads"] and max(res["grads"]) <= 1e-5, res["grads"]
    if CASES[case][0] == "direct":
        assert res["state"] <= 1e-5
