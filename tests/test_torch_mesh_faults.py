"""Three mesh faults of the port against the reference, repaired.

1. **The mLSTM's four row-parallel projections** (``wq``, ``wk``, ``wv``,
   ``w_if``).  Under the sequence-parallel rules u is sharded on its
   tokens and each weight on its rows on the model axis, so
   ``sharding.sp_matmul`` moved u onto its channels (an all-gather on a
   CPU mesh) four times a layer and again in the backward.
   ``sharding.tokens_matmul`` gathers the weight instead and multiplies
   each device's own tokens by it (the up, gate and down products' too);
   decode's one token a row, which the axis does not split, keeps
   ``sp_matmul``.
2. **The MoE's routing in decode.**  A decode step's one group of B
   tokens is split over the data axis only, so every model-axis device
   routed the same tokens.  ``moe._route_groups`` now gives each of them
   a block of the router's columns and of the experts (``_repeat_axes``),
   both padded to a multiple of the devices, and gathers the logits and
   the dispatch and combine blocks (``_gather_blocks``); the gates' and
   the tokens' grads, partial sums of the blocks, are made whole
   (``_whole_over``, ``sharding.whole_grad``).
3. **The decode residual.**  A row-parallel product left ``x + a``
   partial; each norm then reduce-scattered it and each product of the
   normed rows made them whole again (q, k and v each, the FFN's gate
   and up each).  ``sharding.whole_rows`` makes the residual whole once a
   sublayer in ``transformer.decode_step`` (hymba's
   ``hybrid.decode_hymba_block``: each branch's output and the residual).

Each repair is counted on fake meshes under the dry-run's rules beside
its parent form, the old function monkeypatched back in the same run:
the same F, fewer bytes on the wire.  On four gloo ranks (one
``torchrun`` subprocess for every case) each repaired layout gives one
process's values: the mLSTM layer's output and grads and its decode
step; the routing's dispatch and combine exactly (the slots and
``keep``), its aux and grads in fp64, where the model axis does not
divide the tokens or the experts; decode steps of reduced minitron-8b
(layernorm), qwen2-7b and hymba in fp32.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as sp
from repro_torch.models import hybrid, moe, ssm, transformer
from repro_torch.serve import engine
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def _wire(low, kind=None):
    return sum(v for k, v in low.wire_bytes_by_kind.items()
               if kind in (None, k))


# --- 1. the mLSTM's row-parallel projections ---------------------------------

def _mlstm_cfg():
    return get_reduced("xlstm-125m").replace(compute_dtype=torch.float32,
                                             ssm_chunk=16)


def _lower_mlstm(dims, B, S, shape):
    """The reduced mLSTM layer on a fake mesh under the dry-run's rules for
    ``shape``: at S > 1 its forward and backward, at S = 1 one decode
    step from a zero state (no grad)."""
    cfg = _mlstm_cfg()

    def train(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out = ssm.apply_mlstm(tree_unflatten(p, leaves), x, cfg)
        return torch.autograd.grad(out.sum(), leaves + [x])

    def decode(p, x):
        with torch.no_grad():
            return ssm.decode_mlstm(p, x, ssm.init_mlstm_state(
                cfg, x.shape[0], device="cpu"), cfg)

    with mesh_mod.fake_mesh(dims, mesh_mod.AXES) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES[shape])):
            fm = dryrun._fake_mode()
            with fm:
                p = sp.attach(sp.abstract_params(cfg)["blocks"][0]["mlstm"],
                              model_param_specs(cfg)["blocks"][0]["mlstm"],
                              mesh)
                x = sp._laid_out((B, S, cfg.d_model), torch.float32, mesh,
                                 ("batch", "seq" if S > 1 else None,
                                  "embed"))
            return dryrun._run(decode if S == 1 else train, (p, x), fm, 0)


def _gathered(monkeypatch):
    """The mLSTM's ``tokens_matmul`` calls that gathered their weight
    (None for the ones that fell back to ``sp_matmul``)."""
    calls = []
    real, plain = sh.tokens_matmul, sh.sp_matmul

    def spy(u, w):
        fell = []
        monkeypatch.setattr(sh, "sp_matmul",
                            lambda *a: fell.append(1) or plain(*a))
        try:
            out = real(u, w)
        finally:
            monkeypatch.setattr(sh, "sp_matmul", plain)
        calls.append(None if fell else tuple(w.shape))
        return out
    monkeypatch.setattr(ssm, "tokens_matmul", spy)
    return calls


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mlstm_projections_multiply_each_devices_tokens(mesh, monkeypatch):
    """At (8, 64) under the train rules: the four products of u and the
    up, gate and down products gather their weight; F is the parent form's
    (``tokens_matmul`` as ``sp_matmul``) to the flop, the all-gather at
    most half of it and the wire less."""
    dims = MESHES[mesh]
    calls = _gathered(monkeypatch)
    low = _lower_mlstm(dims, 8, 64, "train_4k")
    cfg = _mlstm_cfg()
    H, dh = ssm._heads(cfg)
    D = cfg.d_model
    assert calls == [(D, H * dh)] * 2 + [(H * dh, H * dh)] * 3 + [
        (H * dh, 2 * H), (H * dh, D)]
    monkeypatch.setattr(ssm, "tokens_matmul", sh.sp_matmul)
    parent = _lower_mlstm(dims, 8, 64, "train_4k")
    assert low.flops == parent.flops
    assert _wire(low, "all-gather") <= 0.5 * _wire(parent, "all-gather")
    assert _wire(low) < _wire(parent)
    assert low.mem_bytes <= parent.mem_bytes


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mlstm_decode_keeps_sp_matmul(mesh, monkeypatch):
    """Decode's (B, 1, D) u: no axis splits its tokens, so every product
    falls back to ``sp_matmul`` and the step's F, bytes and wire by kind
    are the parent form's exactly."""
    dims = MESHES[mesh]
    calls = _gathered(monkeypatch)
    low = _lower_mlstm(dims, 4, 1, "decode_32k")
    assert calls == [None] * 6
    monkeypatch.setattr(ssm, "tokens_matmul", sh.sp_matmul)
    parent = _lower_mlstm(dims, 4, 1, "decode_32k")
    assert (low.flops, low.mem_bytes) == (parent.flops, parent.mem_bytes)
    assert low.wire_bytes_by_kind == parent.wire_bytes_by_kind


# --- 2. the MoE's routing in decode ------------------------------------------

#: reduced qwen2-moe with 5 experts (not a multiple of 2 or 4: padded
#: blocks) and reduced qwen3-moe (8 experts)
MOE = {"qwen2": ("qwen2-moe-a2.7b", {"n_experts": 5}),
       "qwen3": ("qwen3-moe-30b-a3b", {})}
#: decode's one group: 10 tokens on 2x2 (5 a data device, which the model
#: axis does not split), 6 on 1x4 (every device holds all 6)
ROUTE_B = {"2x2": 10, "1x4": 6}


def _moe_cfg(model):
    arch, over = MOE[model]
    return get_reduced(arch).replace(compute_dtype=torch.float32, **over)


def _lower_route(model, dims, B):
    """``moe._route_groups`` of decode's one group of B tokens on a fake
    mesh, laid out as ``moe._groups`` lays it (the data axis splits the
    tokens, the model axis holds them all)."""
    cfg = _moe_cfg(model)
    E_pad, C = moe._padded_e(cfg), moe._capacity(B, cfg)

    def route(xt, router):
        with torch.no_grad():
            return moe._route_groups(xt, router, cfg, C, E_pad)

    with mesh_mod.fake_mesh(dims, mesh_mod.AXES) as mesh:
        fm = dryrun._fake_mode()
        n = mesh.size(0)
        with fm:
            from torch.distributed.tensor import DTensor
            xt = DTensor.from_local(
                torch.empty((1, B // n, cfg.d_model)), mesh,
                (Shard(1) if n > 1 else Replicate(), Replicate()),
                run_check=False, shape=(1, B, cfg.d_model),
                stride=(B * cfg.d_model, cfg.d_model, 1))
            router = DTensor.from_local(
                torch.empty((cfg.d_model, cfg.n_experts)), mesh,
                (Replicate(), Replicate()), run_check=False)
        return dryrun._run(route, (xt, router), fm, 0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", sorted(MOE))
def test_decode_routing_runs_once_across_the_model_axis(model, mesh,
                                                        monkeypatch):
    """F x 4 / F(1x1) of the routing is the experts' padding and no more:
    every product of ``_route_groups`` is linear in the experts, padded to
    a multiple of the model axis (qwen3's 8 experts: 1.0; qwen2's 5: 6 / 5
    on 2x2, 8 / 5 on 1x4; at full width 64 / 60 and 1.0 on 16).  The
    parent form (no repeat axis) routes every token on every model device:
    2.0 on 2x2, 4.0 on 1x4."""
    dims, B, E = MESHES[mesh], ROUTE_B[mesh], _moe_cfg(model).n_experts
    n = dims[1]
    one = _lower_route(model, (1, 1), B).flops
    low = _lower_route(model, dims, B)
    assert low.flops * 4 / one == pytest.approx(-(-E // n) * n / E)
    monkeypatch.setattr(moe, "_repeat_axes", lambda mesh, g: ((), 1, 0))
    parent = _lower_route(model, dims, B)
    assert parent.flops * 4 / one == pytest.approx(n)


def test_repeat_axes_and_blocks_in_mesh_order():
    """``_repeat_axes`` on hand-made layouts: the replicated axes of more
    than one device, their device count, and the block in mesh order."""
    class Mesh:
        ndim = 3

        def __init__(self, sizes, ranks):
            self.sizes, self.ranks = sizes, ranks

        def size(self, i):
            return self.sizes[i]

        def get_local_rank(self, i):
            return self.ranks[i]

    R, S1 = Replicate(), Shard(1)
    assert moe._repeat_axes(Mesh((2, 4, 3), (1, 2, 1)), (S1, R, R)) == \
        ((1, 2), 12, 2 * 3 + 1)
    assert moe._repeat_axes(Mesh((2, 1, 3), (1, 0, 2)), (R, R, S1)) == \
        ((0,), 2, 1)
    assert moe._repeat_axes(Mesh((2, 4, 3), (1, 2, 1)), (S1, S1, S1)) == \
        ((), 1, 0)


# --- 3. the decode residual --------------------------------------------------

WIRE_ARCHS = ("minitron-8b", "qwen2-7b", "hymba-1.5b")


def _lower_decode(arch, dims, B=4, s_max=16):
    """One decode step of reduced ``arch`` on a fake mesh under the
    dry-run's decode rules, as ``launch.dryrun`` lowers a decode cell."""
    cfg = get_reduced(arch)
    shape = ShapeSpec("decode_wire", s_max, B, "decode")
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
            step = engine.build_serve_step(cfg)

            def run(params, tokens, cache):
                with torch.no_grad():
                    return step(params, tokens, cache, dec["pos"])
            return dryrun._run(run, (params, dec["tokens"], cache), fm, 0)


def _norm_inputs(monkeypatch):
    """The placements of every DTensor a decode norm reads."""
    seen = []
    for mod in (transformer, hybrid):
        def spy(p, x, cfg, _real=mod.apply_norm):
            seen.append(tuple(getattr(x, "placements", ())))
            return _real(p, x, cfg)
        monkeypatch.setattr(mod, "apply_norm", spy)
    return seen


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", WIRE_ARCHS)
def test_decode_residual_is_made_whole_once_a_sublayer(arch, mesh,
                                                       monkeypatch):
    """Every norm of the step reads rows that are whole on the model axis
    (the residual; hymba's branch outputs too), never a partial sum or a
    block of channels; F is the parent form's (the residual left partial)
    to the flop and no kind of collective sends more.  Torch 2.13 lowered
    the parent form by a reduce-scatter at each norm and a gather for each
    product of the normed rows (these read 28-43% of its wire after the
    repair; the three cells at decode_32k 16x16 24-30%); torch 2.11 made
    the dense cells' partial whole at the add, which is the repaired form
    (the same bytes), and hymba's branch outputs not."""
    dims = MESHES[mesh]
    cfg = get_reduced(arch)
    seen = _norm_inputs(monkeypatch)
    low = _lower_decode(arch, dims)
    norms = 2 * cfg.n_layers + 1 + (2 * cfg.n_layers
                                    if cfg.family == "hybrid" else 0)
    assert len(seen) == norms
    model = mesh_mod.AXES.index("model")
    assert all(p[model] == Replicate() for p in seen), seen
    for mod in (transformer, hybrid):
        monkeypatch.setattr(mod, "whole_rows", lambda y: y)
    parent = _lower_decode(arch, dims)
    assert low.flops == parent.flops
    for kind, sent in low.wire_bytes_by_kind.items():
        assert sent <= _wire(parent, kind), kind
    assert _wire(low) <= _wire(parent)


# --- four gloo ranks ---------------------------------------------------------

RANKS = r"""
import json, sys, traceback
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs as sp
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.models import moe, ssm, transformer
from repro_torch.serve import engine
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CASES = json.loads(sys.argv[2])
DTYPES = {"float32": torch.float32, "float64": torch.float64}
gathered = []
real, plain = sh.tokens_matmul, sh.sp_matmul


def spy(u, w):
    fell = []
    sh.sp_matmul = lambda *a: fell.append(1) or plain(*a)
    try:
        return real(u, w)
    finally:
        sh.sp_matmul = plain
        gathered.append(not fell)


ssm.tokens_matmul = spy


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    a, b = full(a).double(), b.double()
    scale = b.abs().max()
    return float((a - b).abs().max() / (scale if scale > 0 else 1.0))


def mlstm_case(mesh, B, S):
    cfg = get_reduced("xlstm-125m").replace(compute_dtype=torch.float32,
                                            ssm_chunk=8)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mlstm(cfg, gen, device="cpu")
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    w = torch.randn((B, S, cfg.d_model), generator=gen)
    specs = ssm.mlstm_specs(cfg)

    def train(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out = ssm.apply_mlstm(tree_unflatten(p, leaves), x, cfg)
        g = torch.autograd.grad((full(out) * w).sum(), leaves + [x])
        return [full(out).detach()] + [full(t) for t in g]

    def decode(p, x):
        with torch.no_grad():
            y, (M, n) = ssm.decode_mlstm(
                p, x, ssm.init_mlstm_state(cfg, B, device="cpu"), cfg)
        return [full(y), full(M), full(n)]

    fn, shape = (decode, "decode_32k") if S == 1 else (train, "train_4k")
    want = fn(p, x)
    with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh, SHAPES[shape])), \
            implicit_replication():
        pm = sh.place_tree(p, sh.specs_to_shardings(specs, mesh))
        xm = sh.place(x, sh.NamedSharding(mesh, sh.logical_spec(
            ("batch", "seq" if S > 1 else None, "embed"))))
        got = fn(pm, xm)
    return {"errs": [rel(a, b) for a, b in zip(got, want)],
            "gathered": list(gathered)}


def route_case(mesh, model, B, dtype, capacity):
    arch, over = {"qwen2": ("qwen2-moe-a2.7b", {"n_experts": 5}),
                  "qwen3": ("qwen3-moe-30b-a3b", {})}[model]
    if capacity:
        over = dict(over, capacity_factor=capacity)
    cfg = get_reduced(arch).replace(compute_dtype=DTYPES[dtype], **over)
    gen = torch.Generator().manual_seed(1)
    E_pad, C = moe._padded_e(cfg), moe._capacity(B, cfg)
    dt = cfg.compute_dtype
    xt = torch.randn((1, B, cfg.d_model), generator=gen).to(dt)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen).to(dt)
    w = torch.randn((1, B, E_pad, C), generator=gen).to(dt)
    taken = []
    real_rep = moe._repeat_axes

    def rep(mesh, grouped):
        out = real_rep(mesh, grouped)
        taken.append(out[0])
        return out
    moe._repeat_axes = rep

    def run(xt, router):
        xt = xt.detach().requires_grad_(True)
        router = router.detach().requires_grad_(True)
        d, c, aux = moe._route_groups(xt, router, cfg, C, E_pad)
        loss = (full(c) * w).sum() + 3 * full(aux)
        gx, gr = torch.autograd.grad(loss, [xt, router])
        return full(d), full(c), full(aux), full(gx), full(gr)

    try:
        want = run(xt, router)
        n = mesh.size(0)
        got = run(distribute_tensor(xt, mesh, (Shard(1) if n > 1
                                               else Replicate(),
                                               Replicate())),
                  distribute_tensor(router, mesh,
                                    (Replicate(), Replicate())))
    finally:
        moe._repeat_axes = real_rep
    return {"exact": [bool(torch.equal(a, b))
                      for a, b in zip(got[:2], want[:2])],
            "kept": int(want[0].sum()), "choices": B * cfg.moe_top_k,
            "errs": [rel(a, b) for a, b in zip(got[2:], want[2:])],
            "taken": [list(t) for t in taken]}


def decode_case(mesh, arch, B, S_max, positions):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
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
        for tok, pos in zip(tokens, positions):
            want, _ = transformer.decode_step(params, tok, want_cache, pos,
                                              cfg)
            tm = sh.place(tok, sh.NamedSharding(
                mesh, sh.logical_spec(("batch", None))))
            got, _ = transformer.decode_step(pm, tm, cm, pos, cfg)
            out.append(rel(got, want))
        return {"errs": [max(out), max(
            rel(a, b) for a, b in zip([full(t) for t in tree_leaves(cm)],
                                      tree_leaves(want_cache)))]}


dist.init_process_group("gloo", init_method="env://")
results, meshes = {}, {}
for name, case in CASES.items():
    dims = tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = make_mesh(dims, AXES, device="cpu")
    gathered.clear()
    try:
        if case["kind"] == "mlstm":
            results[name] = mlstm_case(meshes[dims], *case["at"])
        elif case["kind"] == "route":
            results[name] = route_case(meshes[dims], *case["at"])
        else:
            results[name] = decode_case(meshes[dims], *case["at"])
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""


def _cases():
    """name -> {kind, mesh, at}: the mLSTM layer at (4, 32) (train: each
    device's run whole chunks of 8) and its decode step at (4, 1); the
    routing of decode's group in fp64 at capacity 1.0 (choices drop, so
    ``keep`` and the slots read the earlier runs) and at the default
    1.25, and in fp32; decode steps across the cache's shard boundary."""
    cases = {}
    for mesh, dims in MESHES.items():
        cases[f"mlstm_train_{mesh}"] = {"kind": "mlstm", "mesh": dims,
                                        "at": [4, 32]}
        cases[f"mlstm_decode_{mesh}"] = {"kind": "mlstm", "mesh": dims,
                                         "at": [4, 1]}
        for model in sorted(MOE):
            for dtype, cap in (("float64", 1.0), ("float64", None),
                               ("float32", None)):
                tag = f"{dtype[5:]}{'_drops' if cap else ''}"
                cases[f"route_{model}_{mesh}_fp{tag}"] = {
                    "kind": "route", "mesh": dims,
                    "at": [model, ROUTE_B[mesh], dtype, cap]}
        for arch in WIRE_ARCHS:
            cases[f"decode_{arch}_{mesh}"] = {"kind": "decode", "mesh": dims,
                                              "at": [arch, 4, 16, [7, 8, 9]]}
    return cases


CASES = _cases()
FP32_TOL, FP64_TOL = 1e-5, 1e-10


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
                                        if CASES[c]["kind"] == "mlstm"))
def test_mlstm_gives_one_process_values(case, on_four_ranks):
    """The layer's output and every grad (the nine weights and x), or the
    decode step's output and state, within 1e-5 of one process's; the
    four products of u and the down product gather their weight in train,
    and the up and gate products on 1x4 (on 2x2 a device's 2 x 16 x 48 of
    x are fewer than the 48 x 48 of w_up it would receive: the byte rule
    keeps ``sp_matmul``); the six of x and u fall back in decode."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert max(res["errs"]) <= FP32_TOL, res["errs"]
    if "train" in case:
        want = [False] * 7 + ["1x4" in case] * 2 + [True] * 5
    else:
        want = [False] * 12
    assert res["gathered"] == want


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "route"))
def test_split_routing_gives_one_process_values(case, on_four_ranks):
    """Dispatch and combine equal one process's (every slot and ``keep``;
    at capacity 1.0 some choices drop), the aux and the grads of the
    tokens and the router within 1e-10 in fp64 and 1e-5 in fp32; the
    model axis is the repeat axis."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert res["exact"] == [True, True]
    if "drops" in case:
        assert res["kept"] < res["choices"]
    tol = FP64_TOL if "fp64" in case else FP32_TOL
    assert max(res["errs"]) <= tol, res["errs"]
    assert res["taken"] == [[1]]


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "decode"))
def test_decode_steps_give_one_process_values(case, on_four_ranks):
    """Logits of three steps across the cache's shard boundary and the
    whole cache after them within 1e-5 of one process's in fp32."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    assert max(res["errs"]) <= FP32_TOL, res["errs"]
