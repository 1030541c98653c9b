"""The MoE's expert products computed once across the mesh in decode.

A decode step's batch is one dispatch group (decode_32k: 128 tokens, 10
slots an expert), which cannot give every device its own group.  Where a
mesh axis splits the group's tokens against replicated expert weights and
the slots do not divide its devices, each device used to fill the
buffers from its own tokens, make them whole (an all-reduce of every
buffer) and compute every product; where every device of an axis held the
same tokens, each dispatched them all.  ``moe._dispatch`` now splits the
buffers by their D channels there (``moe._channel_axes``): the tokens'
runs traded for channels by all-to-all (``moe._transpose``), the dispatch
gathered; ``moe._experts`` multiplies each device's channels
(``moe._channel_products``: the gate and up products all-reduced as
(G, E, C, F) partial sums, the down product writing the device's
channels), and ``moe._combine`` gathers the combine weights, not the
outputs.  Against experts split on a mesh axis whose devices hold the
same tokens, each device fills only its experts' buffers.

On fake (1, 4), (2, 2) and (2, 2, 2) meshes under the dry-run's decode
rules, reduced qwen3-moe (its experts split on the model axis) and
reduced qwen2-moe with 5 experts (each expert's hidden axis split there)
count F x N / F(1x1) <= 1.05 in ``_dispatch`` and in ``_experts``, and no
more all-reduce a device than before.  On four gloo ranks several decode
steps give one process's logits and cache, and a forward and backward
through ``apply_moe`` one process's output, aux and grads.
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
from repro_torch.measure.counters import MeshCounter
from repro_torch.models import moe
from repro_torch.train.loop import model_param_specs

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: reduced qwen2-moe with an expert count that divides no model axis here,
#: so the decode rules split each expert's hidden axis, as 60 experts on
#: a 16-wide axis do
HIDDEN = {"n_experts": 5}
MODELS = {"qwen3_ep": ("qwen3-moe-30b-a3b", {}),
          "qwen2_hidden": ("qwen2-moe-a2.7b", HIDDEN)}

#: mesh -> decode batch (S = 1, one group).  (1, 4): 6 tokens do not split
#: over the model axis, every device holds them all.  (2, 2): 10 tokens, 5
#: a data device, the slots (3 for qwen3, 5 for qwen2) do not divide 2.
#: (2, 2, 2) (pod, data, model): 12 tokens, 3 a device; qwen3's 3 slots
#: divide neither axis, qwen2's 6 divide the pod's 2 (the slots split
#: there) but not 4.
MESHES = {"1x4": ((1, 4), 6), "2x2": ((2, 2), 10), "2x2x2": ((2, 2, 2), 12)}

#: the layer's all-reduce bytes a device on the parent (the buffers made
#: whole on every data device), read by ``_lower_decode_moe`` on torch
#: 2.13; the shared experts' sum is 1,152 of qwen2's at 1x4
PARENT_ALL_REDUCE = {
    ("qwen3_ep", "1x4"): 1152, ("qwen3_ep", "2x2"): 3776,
    ("qwen3_ep", "2x2x2"): 6656, ("qwen2_hidden", "1x4"): 1152,
    ("qwen2_hidden", "2x2"): 3880, ("qwen2_hidden", "2x2x2"): 2384,
}

COUNTED = ("_dispatch", "_experts")


def _lower_decode_moe(model, dims, B):
    """One MoE layer of the reduced ``model`` at a decode batch (B, 1) on
    a fake mesh of ``dims`` under the dry-run's decode rules, from bf16
    weights as the dry-run serves, its output laid out as its input: each
    of ``COUNTED``'s F, the layer's F and its wire bytes a device by
    kind."""
    arch, over = MODELS[model]
    cfg = get_reduced(arch).replace(**over)
    axes = mesh_mod.PRODUCTION[True][1] if len(dims) == 3 else mesh_mod.AXES
    flops = dict.fromkeys(COUNTED, 0.0)
    with mesh_mod.fake_mesh(dims, axes) as mesh:
        with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                     SHAPES["decode_32k"])):
            fm = dryrun._fake_mode()
            with fm:
                p = dryrun._bf16(sp.attach(
                    sp.abstract_params(cfg)["blocks"][0]["moe"],
                    model_param_specs(cfg)["blocks"][0]["moe"], mesh))
                x = sp._laid_out((B, 1, cfg.d_model), cfg.compute_dtype,
                                 mesh, ("batch", None, "embed"))
            counter = MeshCounter(fake_mode=fm)
            counter.hold((p, x))
            real = {name: getattr(moe, name) for name in COUNTED}

            def counted(name):
                def fn(*args):
                    before = counter.flops
                    out = real[name](*args)
                    flops[name] += counter.flops - before
                    return out
                return fn

            from torch.distributed.tensor.experimental import \
                implicit_replication
            try:
                for name in COUNTED:
                    setattr(moe, name, counted(name))
                with implicit_replication(), counter, torch.no_grad():
                    out, _ = moe.apply_moe(p, x, cfg)
                    # whole as the next layer reads it: torch 2.13 leaves the
                    # shared experts' row-parallel sum partial, 2.11 reduces it
                    out.redistribute(mesh, x.placements)
            finally:
                for name in COUNTED:
                    setattr(moe, name, real[name])
    kinds = {k: b for k, (_, b) in counter.summary.by_kind().items()}
    return flops, counter.flops, kinds


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("module", COUNTED)
def test_each_expert_product_and_dispatch_runs_once(model, mesh, module):
    """F x N / F(1x1) of the module within 0.99-1.05.  The parent read 2.0
    in both modules on the meshes with a data axis (every data device
    computed every product of its model shard, and dispatched its tokens
    into every expert on each model device where the experts are split
    there) and 4.0 in ``_dispatch`` on 1x4 (every model device dispatched
    the same six tokens); 4.0 in ``_experts`` at 2x2x2 for qwen3."""
    dims, B = MESHES[mesh]
    (one, _, _), (many, _, _) = (_lower_decode_moe(model, d, B)
                                 for d in ((1,) * len(dims), dims))
    ratio = many[module] * math.prod(dims) / one[module]
    assert 0.99 <= ratio <= 1.05, ratio


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_the_layer_all_reduces_no_more_than_before(model, mesh):
    """The layer's all-reduce a device is at most the parent's, and where
    a mesh axis splits the tokens the channels' trade (all-to-all) stands
    in for the buffers' all-reduce: qwen3 on 2x2 reads 2,240 B of the
    parent's 3,776 (the (G, E, C, F) partial products and the output's
    partial sum over the experts), qwen2 1,880 of 3,880."""
    dims, B = MESHES[mesh]
    _, _, kinds = _lower_decode_moe(model, dims, B)
    assert kinds.get("all-reduce", 0) <= PARENT_ALL_REDUCE[model, mesh]
    assert ("all-to-all" in kinds) == (dims[0] > 1), kinds


def test_the_channel_axes_are_the_token_axes_whose_slots_do_not_divide():
    """``_channel_axes`` on the groups' layouts of the meshes above: the
    data axis at 2x2 (3 slots on 2 devices), pod and data at 2x2x2 against
    3 slots, data alone against 6 (the pod's 2 split the slots), the
    model axis where every device holds the tokens against the hidden
    split, and nothing where D does not divide the devices or the shards
    would not nest in mesh order."""
    S0, S1, S2, R = sh.Shard(0), sh.Shard(1), sh.Shard(2), sh.Replicate()
    with mesh_mod.fake_mesh((2, 2, 2), mesh_mod.PRODUCTION[True][1]) as m3:
        assert moe._channel_axes((S1, S1, R), (R, R, S0), 3, 64, m3) == \
            ((0, 1), ())
        assert moe._channel_axes((S1, S1, R), (R, R, S2), 6, 64, m3) == \
            ((1,), (2,))
        assert moe._channel_axes((S1, S1, R), (R, R, S2), 6, 6, m3) == \
            ((), ())
        assert moe._slot_axes((True, True, False), (R, R, S2), 6, m3) == \
            (0,)
    with mesh_mod.fake_mesh((2, 2), mesh_mod.AXES) as m2:
        assert moe._channel_axes((S1, R), (R, S0), 3, 64, m2) == ((0,), ())
        assert moe._channel_axes((S1, R), (R, S0), 4, 64, m2) == ((), ())
        assert moe._channel_axes((S0, S0), (R, S2), 3, 64, m2) == ((), ())
        # the model axis splits the tokens too, inside the data axis's
        # runs: trading data's runs would leave it no run of its own
        assert moe._channel_axes((S1, S1), (R, S2), 85, 64, m2) == ((), ())
        assert moe._channel_axes((S1, S1), (R, R), 85, 64, m2) == \
            ((0, 1), ())


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
from repro_torch.models import moe, transformer
from repro_torch.serve import engine
from repro_torch.train.loop import model_param_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CASES = json.loads(sys.argv[2])
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}
real_products = moe._channel_products
taken = []


def counted(*args):
    taken.append(1)
    return real_products(*args)


moe._channel_products = counted


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    return float((full(a).double() - b.double()).abs().max()
                 / b.double().abs().max())


def decode_case(mesh, cfg, B, S_max, positions):
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
        got_leaves = [full(t) for t in tree_leaves(cm)]
        return {"out": max(out),
                "cache": max(rel(a, b) for a, b in
                             zip(got_leaves, tree_leaves(want_cache)))}


def moe_case(mesh, cfg, B):
    gen = torch.Generator().manual_seed(0)
    dt = cfg.compute_dtype
    p = tree_map(lambda t: t.to(dt), moe.init_moe(cfg, gen, device="cpu"))
    x = torch.randn((B, 1, cfg.d_model), generator=gen).to(dt)
    w = torch.randn((B, 1, cfg.d_model), generator=gen).to(dt)

    def grads(p, x):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(p)]
        x = x.detach().requires_grad_(True)
        out, aux = moe.apply_moe(tree_unflatten(p, leaves), x, cfg)
        loss = (full(out) * w).sum() + full(aux)
        g = torch.autograd.grad(loss, leaves + [x])
        return full(out).detach(), float(full(aux)), [full(t) for t in g]

    rules = dryrun._rules_for(cfg, mesh, SHAPES["decode_32k"])
    with sh.use_sharding(mesh, rules), implicit_replication():
        pm = sh.place_tree(p, sh.specs_to_shardings(moe.moe_specs(cfg), mesh))
        xm = sh.place(x, sh.NamedSharding(
            mesh, sh.logical_spec(("batch", None, "embed"))))
        want_out, want_aux, want = grads(p, x)
        got_out, got_aux, got = grads(pm, xm)
    return {"out": rel(got_out, want_out),
            "aux": abs(got_aux - want_aux) / abs(want_aux),
            "grads": [rel(a, b) for a, b in zip(got, want)]}


dist.init_process_group("gloo", init_method="env://")
results = {}
meshes = {}
for name, case in CASES.items():
    dims = tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = make_mesh(dims, AXES, device="cpu")
    cfg = get_reduced(case["arch"]).replace(
        compute_dtype=DTYPES[case["dtype"]], **case["overrides"])
    taken.clear()
    try:
        if case["kind"] == "decode":
            results[name] = decode_case(meshes[dims], cfg, *case["at"])
        else:
            results[name] = moe_case(meshes[dims], cfg, *case["at"])
        results[name]["channel_products"] = len(taken)
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""

#: (2, 2): 10 rows, 5 a data device, slots that do not divide 2: the
#: channel layout on the data axis.  (1, 4): 6 rows on every device: the
#: dispatch sliced to each device's experts (qwen3) or its channels
#: (qwen2).  A cache of 16: steps at 7, 8 and 9 cross the model axis's
#: shard boundary.
AT = {"2x2": ([2, 2], 10), "1x4": ([1, 4], 6)}
STEPS = [7, 8, 9]
#: the forward and backward in fp32 at capacity 1.0, where choices drop
#: (2x2: 14 rows, 3 slots for qwen3 and 5 for qwen2, neither dividing 2).
#: At decode's 1.25 few drop, and the router's grad through the output is
#: then near 0 in exact arithmetic (each token's kept gates, renormalised,
#: sum to one): fp32 reads its rounding, 1.77e-5 of the largest at 1x4 and
#: 2.90e-5 at 2x2 for qwen2 (the parent 1.77e-5 and 1.30e-5).  So that
#: capacity runs in fp64, within ``FP64_TOL``.
DROPS = {"capacity_factor": 1.0}
TRAIN_AT = {"2x2": 14, "1x4": 6}
CASES = {}
for _model, (_arch, _over) in MODELS.items():
    for _mesh, (_dims, _B) in AT.items():
        CASES[f"decode_{_model}_{_mesh}"] = {
            "kind": "decode", "arch": _arch, "overrides": _over,
            "dtype": "float32", "mesh": _dims, "at": [_B, 16, STEPS]}
        CASES[f"train_{_model}_{_mesh}"] = {
            "kind": "moe", "arch": _arch, "overrides": dict(_over, **DROPS),
            "dtype": "float32", "mesh": _dims, "at": [TRAIN_AT[_mesh]]}
        CASES[f"train_{_model}_{_mesh}_fp64"] = {
            "kind": "moe", "arch": _arch, "overrides": _over,
            "dtype": "float64", "mesh": _dims, "at": [_B]}
    CASES[f"decode_{_model}_2x2_bf16"] = {
        "kind": "decode", "arch": _arch, "overrides": _over,
        "dtype": "bfloat16", "mesh": [2, 2], "at": [10, 16, STEPS]}

FP32_TOL = 1e-5
FP64_TOL = 1e-10
#: bf16: the logits and the cache against one process's, relative to the
#: largest entry, as ``tests/test_torch_decode_shards.py`` holds them: ten
#: units of bf16 roundoff.  The channels' partial products add in another
#: order than one process's contraction.
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


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "decode"))
def test_decode_steps_give_one_process_values(case, on_four_ranks):
    """Logits of each step and the whole cache after them.  On 2x2 every
    layer takes the channel products (one a layer a step)."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    tol = FP32_TOL if CASES[case]["dtype"] == "float32" else BF16_TOL
    assert res["out"] <= tol and res["cache"] <= tol, res
    if CASES[case]["mesh"] == [2, 2]:
        layers = get_reduced(CASES[case]["arch"]).n_layers
        assert res["channel_products"] == layers * len(STEPS)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "moe"))
def test_forward_and_backward_give_one_process_values(case, on_four_ranks):
    """The output, the aux loss and every grad (router, the three expert
    weights, the shared FFN's, x) within 1e-5 of one process's in fp32,
    1e-10 in fp64."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    tol = FP32_TOL if CASES[case]["dtype"] == "float32" else FP64_TOL
    assert res["out"] <= tol and res["aux"] <= tol, res
    assert res["grads"] and max(res["grads"]) <= tol, res["grads"]
    assert res["channel_products"] == (1 if CASES[case]["mesh"] == [2, 2] else 0)
