"""The sequence-parallel products on each device's own tokens.

Under the sequence-parallel rules (``seq`` on the model axis: every train
cell, and the prefill cells whose heads do not divide the model axis) x's
tokens are split on the model axis and the FFN's and the LM head's weights
on their columns or rows there.  ``sharding.sp_matmul`` moved the
activation: x's tokens gathered for a column shard, x moved onto its
channels for a row shard (its partial output reduce-scattered after), the
head's vocab-sharded logits moved back to the tokens by all-to-all.  The
reference's XLA gathers the weights instead.  ``sharding.tokens_matmul``
does the same: it gathers w on each axis that splits both x's tokens and
w, and each device multiplies its own tokens by it, where the weight's
bytes are fewer than the activation's (the byte rule); anything else keeps
``sp_matmul``.  ``ffn._mm`` (every FFN), ``transformer._head``,
``encdec._logits`` and the mLSTM's products call it.

Counted on fake 1x4 and 2x2 meshes under the dry-run's rules, each beside
the parent form (``_weight_gathers`` monkeypatched to keep ``sp_matmul``
in the same run, so that one torch version's lowering is compared with
itself): F equal, the wire and B_M no more.  On four gloo ranks (one
``torchrun`` for every case) the helper on hand-made layouts (a dim split
over both mesh axes: the gathers' order), the SwiGLU and GELU + bias FFNs,
the tied head and three models' loss and grads give one process's values.
A subprocess lowers the reference's reduced whisper at 2 and 4 layers: its
encdec scans its layers whatever ``scan_layers`` says, so XLA's wire is
the same at both depths (ROADMAP's "Not port faults").
"""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.measure.counters import MeshCounter

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("smollm-135m", "whisper-tiny", "qwen2-7b")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
B, S = 8, 256


def _reduced(arch):
    """The reduced config's fields as overrides of the full one, the
    layers unrolled; the learned positions are the cell's."""
    full, red = get_config(arch), get_reduced(arch)
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
          if getattr(red, f.name) != getattr(full, f.name)}
    ov.pop("max_seq_len", None)
    ov["scan_layers"] = False
    return ov


def _sequence_parallel(arch, kind, dims):
    """Whether the dry-run's rules lay ``seq`` on the model axis."""
    return kind == "train" or get_reduced(arch).n_heads % dims[1] != 0


def _plans(monkeypatch):
    """Whether each ``tokens_matmul`` call took the weight form."""
    taken, real = [], sh._weight_gathers

    def spy(*args):
        plan = real(*args)
        taken.append(plan is not None)
        return plan
    monkeypatch.setattr(sh, "_weight_gathers", spy)
    return taken


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_products_move_no_more_than_the_parent_form(arch, kind, mesh,
                                                        monkeypatch):
    """At (8, 256): under the sequence-parallel rules some products take
    the weight form (all of them but where the byte rule keeps
    ``sp_matmul``), otherwise none; F equals the parent form's to the flop
    and neither the wire nor B_M grows."""
    name = f"{kind}_b{B}_s{S}"
    monkeypatch.setitem(dryrun.SHAPES, name, ShapeSpec(name, S, B, kind))
    taken = _plans(monkeypatch)
    low = dryrun.lower_cell(arch, name, mesh, overrides=_reduced(arch),
                            probe=False)[1]
    assert taken and any(taken) == _sequence_parallel(arch, kind,
                                                      MESHES[mesh])
    monkeypatch.setattr(sh, "_weight_gathers", lambda *a: None)
    parent = dryrun.lower_cell(arch, name, mesh, overrides=_reduced(arch),
                               probe=False)[1]
    assert low.flops == parent.flops
    assert low.wire_bytes <= parent.wire_bytes
    assert low.mem_bytes <= parent.mem_bytes
    if any(taken):
        assert low.wire_bytes < parent.wire_bytes


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_keeps_sp_matmul(mesh, monkeypatch):
    """Decode's (B, 1, D) rows: no axis splits their tokens, so no product
    gathers its weight and the step's counts are the parent form's."""
    monkeypatch.setitem(dryrun.SHAPES, "decode_s64",
                        ShapeSpec("decode_s64", 64, B, "decode"))
    taken = _plans(monkeypatch)
    low = dryrun.lower_cell("smollm-135m", "decode_s64", mesh,
                            overrides=_reduced("smollm-135m"),
                            probe=False)[1]
    cfg = get_reduced("smollm-135m")
    assert taken == [False] * (cfg.n_layers * 3 + 1)
    monkeypatch.setattr(sh, "_weight_gathers", lambda *a: None)
    parent = dryrun.lower_cell("smollm-135m", "decode_s64", mesh,
                               overrides=_reduced("smollm-135m"),
                               probe=False)[1]
    assert (low.flops, low.mem_bytes) == (parent.flops, parent.mem_bytes)
    assert low.wire_bytes_by_kind == parent.wire_bytes_by_kind


def _laid(mesh, shape, placements):
    return sh.place(torch.randn(shape), sh.NamedSharding(mesh, placements))


@pytest.mark.parametrize("tokens, gathers", [(64, True), (8, False)])
def test_the_byte_rule_sets_the_weight_against_the_activation(tokens,
                                                              gathers):
    """(4, tokens, 32) sequence-split on the 4-wide model axis against a
    (32, 128) column shard: at 64 tokens a device holds 4 x 16 x 32 of x
    and receives 3 x 32 x 32 of w, fewer than the 3 x 4 x 16 x 32 of x
    that sp_matmul gathers; at 8 tokens the activation is the smaller and
    the product is ``sp_matmul``'s, collective for collective."""
    with mesh_mod.fake_mesh((1, 4), ("data", "model")) as mesh:
        x = _laid(mesh, (4, tokens, 32), ("data", "model", None))
        w = _laid(mesh, (32, 128), (None, "model"))
        assert (sh._weight_gathers(x, w, None) is not None) == gathers
        counted = []
        for fn in (sh.tokens_matmul, sh.sp_matmul):
            counter = MeshCounter()
            with counter:
                y = fn(x, w)
            counted.append(([(o.kind, o.bytes_result)
                             for o in counter.collectives], y.placements))
        if gathers:
            ops, placements = counted[0]
            assert ops == [("all-gather", 32 * 128 * 4)]
            assert placements == x.placements
        else:
            assert counted[0] == counted[1]


def test_layouts_the_helper_does_not_take_keep_sp_matmul():
    """A weight split over the batch's devices (FSDP), one whose tokens
    are whole (tensor parallelism), a partial or channel-split x and a
    bias split otherwise than w's columns keep ``sp_matmul``; plain
    tensors are ``x @ w + bias``."""
    with mesh_mod.fake_mesh((2, 2), ("data", "model")) as mesh:
        x = _laid(mesh, (4, 64, 8), ("data", "model", None))
        w = _laid(mesh, (8, 4), (None, "model"))
        b = _laid(mesh, (4,), ("model",))
        assert sh._weight_gathers(x, w, b) == ([1], [Partial(), Shard(1)],
                                               [Partial(), Shard(0)])
        fsdp = _laid(mesh, (8, 4), ("data", "model"))
        whole = _laid(mesh, (4, 64, 8), ("data", None, None))
        channels = _laid(mesh, (4, 64, 8), ("data", "model", "model"))
        partial = DTensor.from_local(torch.randn(2, 64, 8), mesh,
                                     (Shard(0), Partial()))
        b_data = _laid(mesh, (4,), ("data",))
        for args in ((x, fsdp, None), (whole, w, None),
                     (partial, w, None), (x, w, b_data),
                     (channels, _laid(mesh, (8, 4), ("model", None)), None)):
            assert sh._weight_gathers(*args) is None
    x, w, b = torch.randn(3, 5), torch.randn(5, 2), torch.randn(2)
    assert torch.equal(sh.tokens_matmul(x, w, b), x @ w + b)


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
from repro_torch.models import encdec, ffn, transformer
from repro_torch.train.loop import make_loss_fn, model_param_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CASES = json.loads(sys.argv[2])
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
taken = []
real = sh._weight_gathers


def spy(*args):
    plan = real(*args)
    taken.append(plan is not None)
    return plan


sh._weight_gathers = spy


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(got, want, names=None):
    # each error relative to its largest element; a key bias's relative to
    # its wk's: softmax is invariant to the shift q . bk it adds to every
    # score of a row, so its grad is 0 in exact arithmetic
    err = [float((full(a).double() - b.double()).abs().max())
           for a, b in zip(got, want)]
    scale = [float(b.double().abs().max()) for b in want]
    names = names or [""] * len(want)
    for i, name in enumerate(names):
        if name.endswith("/bk"):
            scale[i] = scale[names.index(name[:-2] + "wk")]
    return [e / (s if s > 0 else 1.0) for e, s in zip(err, scale)]


def jittered(tree, gen):
    # every leaf drawn at random (the biases and norms too), small
    return tree_map(lambda t: (torch.randn(t.shape, generator=gen) * 0.1)
                    .to(t.dtype) if t.is_floating_point() else t, tree)


def grads(fn, tree, *inputs):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    ins = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(tree_unflatten(tree, leaves), *ins)
    loss = out if out.ndim == 0 else full(out).float().pow(2).sum()
    wrt = leaves + [t for t in ins if t.requires_grad]
    g = torch.autograd.grad(loss, wrt)
    return [full(out).detach()] + [full(t) for t in g]


def helper_case(mesh, x_place, w_place, b_place, shape):
    gen = torch.Generator().manual_seed(0)
    D, F = shape[-1], 12
    x = torch.randn(shape, generator=gen)
    w = torch.randn((D, F), generator=gen)
    b = torch.randn((F,), generator=gen)
    fn = lambda p, x: sh.tokens_matmul(x, p["w"], p["b"])
    want = grads(fn, {"w": w, "b": b}, x)
    taken.clear()
    pl = lambda spec: tuple(Replicate() if a is None else Shard(a)
                            for a in spec)
    with implicit_replication():
        got = grads(fn, {"w": distribute_tensor(w, mesh, pl(w_place)),
                         "b": distribute_tensor(b, mesh, pl(b_place))},
                    distribute_tensor(x, mesh, pl(x_place)))
    return got, want


def ffn_case(mesh, arch, dtype):
    cfg = get_reduced(arch).replace(compute_dtype=DTYPES[dtype])
    gen = torch.Generator().manual_seed(1)
    p = jittered(ffn.init_ffn(cfg, gen, device="cpu"), gen)
    x = torch.randn((8, 64, cfg.d_model), generator=gen)
    fn = lambda p, x: ffn.apply_ffn(p, x, cfg)
    want = grads(fn, p, x)
    taken.clear()
    with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                  SHAPES["train_4k"])), \
            implicit_replication():
        pm = sh.place_tree(p, sh.specs_to_shardings(ffn.ffn_specs(cfg),
                                                      mesh))
        xm = sh.place(x, sh.NamedSharding(mesh, sh.logical_spec(
            ("batch", "seq", "embed"))))
        got = grads(fn, pm, xm)
    return got, want


def head_case(mesh, arch):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    params = jittered(transformer.init_lm(cfg, gen, device="cpu"), gen)
    p = {"final_norm": params["final_norm"], "embed": params["embed"]}
    x = torch.randn((8, 256, cfg.d_model), generator=gen)
    fn = lambda p, x: transformer._head(p, x, cfg)
    want = grads(fn, p, x)
    taken.clear()
    specs = model_param_specs(cfg)
    with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                  SHAPES["train_4k"])), \
            implicit_replication():
        pm = sh.place_tree(p, sh.specs_to_shardings(
            {k: specs[k] for k in p}, mesh))
        xm = sh.place(x, sh.NamedSharding(mesh, sh.logical_spec(
            ("batch", "seq", "embed"))))
        got = grads(fn, pm, xm)
    return got, want


def loss_case(mesh, arch):
    cfg = get_reduced(arch).replace(compute_dtype=torch.float32,
                                    max_seq_len=256, remat="none")
    gen = torch.Generator().manual_seed(3)
    init = encdec.init_encdec if cfg.family == "encdec" else \
        transformer.init_lm
    params = jittered(init(cfg, gen, device="cpu"), gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 256),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (8, 256),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((8, cfg.encoder_seq, cfg.d_model),
                                      generator=gen)
    loss_fn = make_loss_fn(cfg)
    keys = sorted(batch)
    fn = lambda p, *ins: loss_fn(p, dict(zip(keys, ins)))[0]
    want = grads(fn, params, *(batch[k] for k in keys))
    taken.clear()
    axes = sp.input_axes(cfg)
    with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh,
                                                  SHAPES["train_4k"])), \
            implicit_replication():
        pm = sh.place_tree(params, sh.specs_to_shardings(
            model_param_specs(cfg), mesh))
        ins = [sh.place(batch[k], sh.NamedSharding(
            mesh, sh.logical_spec(axes[k]))) for k in keys]
        got = grads(fn, pm, *ins)
    names = ["loss"] + [path for path, _ in sp._leaves_with_paths(params)]
    return got, want, names + ["frames"] * (len(want) - len(names))


dist.init_process_group("gloo", init_method="env://")
results, meshes = {}, {}
for name, case in CASES.items():
    dims = tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = make_mesh(dims, AXES, device="cpu")
    taken.clear()
    try:
        out = {"helper": helper_case, "ffn": ffn_case,
               "head": head_case, "loss": loss_case}[case["kind"]](
            meshes[dims], *case["at"])
        results[name] = {"errs": rel(*out), "n": len(out[1]),
                         "taken": list(taken)}
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""


def _cases():
    """name -> {kind, mesh, at}: the helper on 2x2 with a dim split over
    both axes (the gathers' order) and on the sequence-parallel layout;
    the FFNs at (8, 64), the tied head and the models' loss at (8, 256)
    under the train rules."""
    cases = {       # x's, w's and the bias's Shard dim a mesh dim; x's shape
        "helper_columns_both_axes": [[1, 1], [1, 1], [0, 0], [4, 16, 8]],
        "helper_rows_both_axes": [[1, 1], [0, 0], [None, None], [4, 16, 8]],
        "helper_columns_sp": [[0, 1], [None, 1], [None, 0], [4, 32, 8]],
        "helper_rows_sp": [[0, 1], [None, 0], [None, None], [4, 32, 8]],
    }
    cases = {k: {"kind": "helper", "mesh": [2, 2], "at": v}
             for k, v in cases.items()}
    for mesh, dims in MESHES.items():
        for arch, dtype in (("smollm-135m", "float32"),
                            ("whisper-tiny", "float32"),
                            ("smollm-135m", "bfloat16")):
            cases[f"ffn_{arch}_{dtype}_{mesh}"] = {
                "kind": "ffn", "mesh": dims, "at": [arch, dtype]}
        cases[f"head_smollm-135m_{mesh}"] = {
            "kind": "head", "mesh": dims, "at": ["smollm-135m"]}
        for arch in ARCHS:
            cases[f"loss_{arch}_{mesh}"] = {"kind": "loss", "mesh": dims,
                                            "at": [arch]}
    return cases


CASES = _cases()
FP32_TOL, BF16_TOL = 1e-5, 4e-2


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
        capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_products_give_one_process_values(case, on_four_ranks):
    """The output and every grad (weights, biases, norms, inputs; a
    model's loss and all its parameters') within 1e-5 of one process's
    in fp32, 4e-2 in bf16, each relative to its largest element (a key
    bias's to its wk's, as ``test_torch_encdec_shards.py`` holds it); the
    weight form is taken in every case (the helper's and the FFN's every
    product; one of a model's products at least)."""
    res = on_four_ranks[case]
    assert "error" not in res, res.get("error")
    tol = BF16_TOL if "bfloat16" in case else FP32_TOL
    assert max(res["errs"]) <= tol, res["errs"]
    assert any(res["taken"]), res["taken"]
    if case.startswith(("helper", "ffn", "head")):
        assert all(res["taken"]), res["taken"]


# --- the reference's encdec counts one layer a stack -------------------------

REFERENCE = """
import dataclasses, json, sys
from repro.launch import dryrun     # first: XLA_FLAGS before jax starts
from repro.configs import get_config, get_reduced
from repro.configs.shapes import ShapeSpec
dryrun.SHAPES["prefill_s32"] = ShapeSpec("prefill_s32", 32, 8, "prefill")
out = {}
for arch in ("whisper-tiny", "smollm-135m"):
    full, red = get_config(arch), get_reduced(arch)
    ov = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
          if getattr(red, f.name) != getattr(full, f.name)}
    ov.pop("max_seq_len", None)
    ov["scan_layers"] = False
    for k in (2, 4):
        depth = dict(ov, n_layers=k)
        if arch == "whisper-tiny":
            depth["encoder_layers"] = k
        rep = dryrun.lower_cell(arch, "prefill_s32", "1x4",
                                overrides=depth, probe=False)[0]
        out[f"{arch}:{k}"] = [rep.flops, rep.wire_bytes]
print(json.dumps(out))
"""


def test_the_references_encdec_counts_one_layer_a_stack():
    """The reference's reduced whisper prefill cell (8, 32) on 1x4 at 2
    and 4 layers a stack, ``scan_layers=False``: the wire is the same at
    both depths and F within 1% (``src/repro/models/encdec.py`` scans its
    layers whatever the flag says, and XLA counts a scanned body once),
    where its smollm, unrolled, grows with the depth."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    (f2, wire2), (f4, wire4) = got["whisper-tiny:2"], got["whisper-tiny:4"]
    assert wire2 == wire4 > 0
    assert f4 / f2 < 1.01       # what grows is outside the scan (0.24%)
    (f2, wire2), (f4, wire4) = got["smollm-135m:2"], got["smollm-135m:4"]
    assert f4 / f2 > 1.5 and wire4 > wire2
