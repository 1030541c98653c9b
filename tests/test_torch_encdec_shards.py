"""whisper's encoder on each device's own frames.

Under the dry-run's rules for a model whose heads do not divide the model
axis, the ``seq`` rule lays the residual stream over that axis.  The
encoder's frames (1,500 for whisper-tiny) need not divide it: the hint
then drops to replicated, and every model-axis device used to run the
whole encoder's attention and the cross-attention's K/V projections
(whisper-tiny train_4k 16x16 F x N / F(1x1) 1.8937).  ``encdec._encode``
now pads the frames with zero rows to a multiple of the axis's extent
(``encdec._pad_frames``), lays them out on it, and masks the padded keys
with a (T_p,) key bias that ``attention._sdpa_on_shards`` applies to
every query row; ``encode`` hands back the real frames.

On fake (1, 4), (2, 2) and (2, 2, 2) meshes under the dry-run's train and
prefill rules, reduced whisper with 63 frames (64 padded, as 1,500 are
1,504 on 16) and 3 heads counts F x N / F(1x1) <= 1.05 in ``_encode`` and
in the cross-attention's projections, and no more B_M a device than the
parent's encoder (rebuilt here, ``_parent_encode``) does; 64 frames,
which divide, take the parent's path, count for count.
On four gloo ranks a forward's logits, a loss and every grad, and
``init_encdec_cache``'s cross K/V give one process's values.
"""
import functools
import json
import math
import os
import pathlib
import socket
import subprocess
import sys

import pytest

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.measure.counters import MeshCounter
from repro_torch.models import attention, encdec, ffn
from repro_torch.models.common import apply_norm, sinusoidal_positions

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: 3 heads divide no model axis here, so the rules shard the sequence (and
#: the frames) over it; 63 frames divide neither 2 nor 4, 64 divide both
HEADS = {"n_heads": 3, "n_kv_heads": 3}
ODD, EVEN = 63, 64

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "2x2x2": (2, 2, 2)}
#: S 16 divides every model axis; prefill's batch of 16 keeps the rules'
#: batch sharding (below 16 they replicate it)
SHAPES = {"train": ShapeSpec("encdec_train", 16, 8, "train"),
          "prefill": ShapeSpec("encdec_prefill", 16, 16, "prefill")}

#: ``_encode``, and ``_project_qkv``'s calls from the cross-attention (its
#: query's projection, on the decoder's tokens, was never repeated)
COUNTED = ("_encode", "cross_qkv")


def _parent_encode(params, frames, cfg):
    """The parent's encoder, as ``_encode`` returns it: its frames laid
    out by the hint alone (replicated where the mesh does not divide
    them), no key bias."""
    dt = cfg.compute_dtype
    x = frames.to(dt) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, device=frames.device).to(dt)
    x = sh.shard_hint(x, encdec.FRAMES)
    for blk in params["enc_blocks"]:
        h = apply_norm(blk["attn_norm"], x, cfg)
        x = x + attention.apply_attention(blk["attn"], h, cfg, causal=False)
        h = apply_norm(blk["ffn_norm"], x, cfg)
        x = x + ffn.apply_ffn(blk["ffn"], h, cfg)
        x = sh.shard_hint(x, encdec.FRAMES)
    return apply_norm(params["enc_norm"], x, cfg), None


@functools.lru_cache(maxsize=None)
def _lower(kind, dims, frames, parent=False):
    """The reduced whisper step with ``frames`` encoder frames (``kind``:
    the train step or the prefill forward) on a fake mesh of ``dims``
    under the dry-run's rules, through ``_encode`` or (``parent``) the
    parent's encoder: the F a device of each of ``COUNTED``, the number of
    ``_pad_frames`` calls, and the step's counts a device
    (``dryrun.Lowered``)."""
    shape = SHAPES[kind]
    cfg = dryrun._prepare_cfg(get_reduced("whisper-tiny").replace(
        encoder_seq=frames, **HEADS), shape)
    axes = mesh_mod.PRODUCTION[True][1] if len(dims) == 3 else mesh_mod.AXES
    flops = dict.fromkeys(COUNTED, 0.0)
    pads, live = [], []

    class Recorded(MeshCounter):
        def __enter__(self):
            live.append(self)
            return super().__enter__()

    real = (encdec._encode, encdec._pad_frames, attention._project_qkv)
    run_encoder = _parent_encode if parent else real[0]

    def encode(*args):
        before = live[-1].flops
        out = run_encoder(*args)
        flops["_encode"] += live[-1].flops - before
        return out

    def pad(*args):
        pads.append(1)
        return real[1](*args)

    def project(p, x, kv_src, cfg):
        before = live[-1].flops
        out = real[2](p, x, kv_src, cfg)
        if kv_src is not x:
            flops["cross_qkv"] += live[-1].flops - before
        return out

    encdec._encode, encdec._pad_frames, attention._project_qkv = \
        encode, pad, project
    dryrun.MeshCounter = Recorded
    try:
        with mesh_mod.fake_mesh(dims, axes) as mesh:
            with sh.use_sharding(mesh, dryrun._rules_for(cfg, mesh, shape)):
                low, _ = dryrun._lower_one(cfg, shape, mesh, 0)
    finally:
        encdec._encode, encdec._pad_frames, attention._project_qkv = real
        dryrun.MeshCounter = MeshCounter
    return flops, len(pads), low


def _ratio(kind, dims, module, parent=False):
    one, _, _ = _lower(kind, (1,) * len(dims), ODD)
    many, _, _ = _lower(kind, dims, ODD, parent)
    return many[module] * math.prod(dims) / one[module]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("module", COUNTED)
def test_the_encoder_and_the_cross_projections_run_once(kind, mesh, module):
    """F x N / F(1x1) within 0.99-1.05 (1.019 and 1.014 on torch 2.13: the
    padded frame's share), where the parent's encoder reads at least 1.5
    (2.785 and 3.662 at 1x4: every model device ran the encoder's
    attention and the cross K/V projections, the FFN and the query's
    projection split; 1.595 and 1.887 where the model axis is 2)."""
    dims = MESHES[mesh]
    ratio = _ratio(kind, dims, module)
    assert 0.99 <= ratio <= 1.05, ratio
    assert _lower(kind, dims, ODD)[1] == 1
    assert _ratio(kind, dims, module, parent=True) >= 1.5


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_no_device_reads_more_than_before(kind, mesh):
    """B_M a device at most the parent encoder's: each device reads its own
    frames' activations, where it read every frame's (train at 1x4 on
    torch 2.13: 63,016,584 B of the parent's 93,608,248)."""
    dims = MESHES[mesh]
    _, _, low = _lower(kind, dims, ODD)
    _, _, before = _lower(kind, dims, ODD, parent=True)
    assert low.mem_bytes <= before.mem_bytes


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_frames_that_divide_take_the_parents_path(kind, mesh):
    """64 frames: nothing padded, and the step's F, B_M, peak and wire
    bytes by kind are the parent encoder's, count for count; one device
    pads nothing either."""
    dims = MESHES[mesh]
    _, pads, low = _lower(kind, dims, EVEN)
    _, _, before = _lower(kind, dims, EVEN, parent=True)
    _, one_pads, _ = _lower(kind, (1,) * len(dims), ODD)
    assert pads == 0 and one_pads == 0
    assert low == before


# --- on four gloo ranks ------------------------------------------------------

RANKS = r"""
import json, sys, traceback
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, specs as sp
from repro_torch.launch.mesh import AXES, make_mesh
from repro_torch.models import encdec
from repro_torch.train.loop import make_loss_fn, model_param_specs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

CASES = json.loads(sys.argv[2])
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
padded = []
real_pad = encdec._pad_frames


def pad(*args):
    padded.append(1)
    return real_pad(*args)


encdec._pad_frames = pad


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def rel(a, b):
    return float((full(a).double() - b.double()).abs().max()
                 / b.double().abs().max())


def inputs(cfg, B, S):
    gen = torch.Generator().manual_seed(0)
    # every leaf drawn, the biases and the norms' too
    params = tree_map(lambda t: (t + 0.1 * torch.randn(t.shape,
                                                       generator=gen)),
                      encdec.init_encdec(cfg, gen, device="cpu"))
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    return params, frames, tokens[:, :-1], tokens[:, 1:]


def place(mesh, params, batch, cfg):
    pm = sh.place_tree(params, sh.specs_to_shardings(
        model_param_specs(cfg), mesh))
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
            "frames": ("batch", "seq", "embed")}
    return pm, {k: sh.place(v, sh.NamedSharding(
        mesh, sh.logical_spec(axes[k]))) for k, v in batch.items()}


def run(mesh, case):
    kind = "train" if case["kind"] == "train" else "prefill"
    cfg = dryrun._prepare_cfg(get_reduced("whisper-tiny").replace(
        compute_dtype=DTYPES[case["dtype"]], **case["overrides"]),
        ShapeSpec("s", case["S"], case["B"], kind))
    params, frames, tokens, labels = inputs(cfg, case["B"], case["S"])
    batch = {"tokens": tokens, "labels": labels, "frames": frames}
    rules = dryrun._rules_for(cfg, mesh, ShapeSpec("s", case["S"],
                                                   case["B"], kind))
    with sh.use_sharding(mesh, rules), implicit_replication():
        pm, bm = place(mesh, params, batch, cfg)
        if case["kind"] == "forward":
            with torch.no_grad():
                want = encdec.forward(params, tokens, frames, cfg)[0]
                got = encdec.forward(pm, bm["tokens"], bm["frames"], cfg)[0]
            return {"logits": rel(got, want)}
        if case["kind"] == "cache":
            with torch.no_grad():
                want = encdec.init_encdec_cache(params, frames, case["B"],
                                                case["S"], cfg)
                got = encdec.init_encdec_cache(pm, bm["frames"], case["B"],
                                               case["S"], cfg)
            return {k: rel(got[k], want[k]) for k in ("cross_k", "cross_v")}
        loss_fn = make_loss_fn(cfg)

        def grads(p, b):
            # the frames' grad too: it crosses the padding's layout
            leaves = [v.detach().requires_grad_(True)
                      for v in tree_leaves(p) + [b["frames"]]]
            loss, _ = loss_fn(tree_unflatten(p, leaves[:-1]),
                              dict(b, frames=leaves[-1]))
            g = torch.autograd.grad(full(loss), leaves)
            return float(full(loss)), [full(t).double() for t in g]

        want_loss, want = grads(params, batch)
        got_loss, got = grads(pm, bm)
        paths = [path for path, _ in sp._leaves_with_paths(params)]
        paths.append("frames")
        return {"loss": abs(got_loss - want_loss) / abs(want_loss),
                "grads": {path: [float((a - b).abs().max()),
                                 float(b.abs().max())]
                          for path, a, b in zip(paths, got, want)},
                "finite": all(bool(torch.isfinite(t).all()) for t in got)}


dist.init_process_group("gloo", init_method="env://")
results, meshes = {}, {}
for name, case in CASES.items():
    dims = tuple(case["mesh"])
    if dims not in meshes:
        meshes[dims] = make_mesh(dims, AXES, device="cpu")
    padded.clear()
    try:
        results[name] = run(meshes[dims], case)
        results[name]["padded"] = len(padded)
    except Exception:      # every rank raises alike: the next case runs
        results[name] = {"error": traceback.format_exc()}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""

#: (2, 2) and (1, 4): 63 frames padded to 64 on a model axis of 2 or 4; a
#: batch of 4 and 16 tokens divide both meshes' axes
RANK_MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
CASES = {}
for _mesh, _dims in RANK_MESHES.items():
    for _kind in ("forward", "train", "cache"):
        for _dtype in ("float32", "bfloat16"):
            CASES[f"{_kind}_{_mesh}_{_dtype}"] = {
                "kind": _kind, "mesh": _dims, "dtype": _dtype, "B": 4,
                "S": 16, "overrides": dict(HEADS, encoder_seq=ODD)}
#: 64 frames on 2x2: nothing padded, the values as one process's
CASES["train_2x2_float32_even"] = dict(CASES["train_2x2_float32"],
                                       overrides=dict(HEADS,
                                                      encoder_seq=EVEN))

FP32_TOL = 1e-5
#: bf16: relative to the largest entry, as ``tests/test_torch_moe_shards.py``
#: holds them: ten units of bf16 roundoff (the shards' products add in
#: another order than one process's)
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


def _result(case, results):
    res = results[case]
    assert "error" not in res, res.get("error")
    # the sharded pass pads once (one process never), and nothing where
    # the frames divide
    odd = CASES[case]["overrides"]["encoder_seq"] == ODD
    assert res["padded"] == (1 if odd else 0), res
    return res, FP32_TOL if CASES[case]["dtype"] == "float32" else BF16_TOL


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "forward"))
def test_the_forward_gives_one_process_logits(case, on_four_ranks):
    res, tol = _result(case, on_four_ranks)
    assert res["logits"] <= tol, res


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "train"))
def test_the_loss_and_every_grad_are_one_process_values(case,
                                                        on_four_ranks):
    """The CE and the grad of every weight (the encoder's, the
    cross-attention's, the tied embedding's) and of the frames, every one
    finite: a padded frame's grads are 0, never NaN.  Each grad is held relative to its
    largest entry, but a key bias's: softmax is invariant to the shift
    q . bk that it adds to every score of a row, so its grad is 0 in exact
    arithmetic and both sides read rounding.  It is held relative to the
    largest grad entry of the same projection's ``wk``."""
    res, tol = _result(case, on_four_ranks)
    assert res["finite"], res
    assert res["loss"] <= tol, res
    grads = res["grads"]
    # every leaf (15 an encoder layer, 24 a decoder layer, 6 outside) and
    # the frames
    assert len(grads) == 2 * 15 + 2 * 24 + 6 + 1, sorted(grads)
    for path, (err, scale) in grads.items():
        if path.endswith("/bk"):
            scale = grads[path[:-2] + "wk"][1]
        assert err <= tol * scale, (path, err, scale)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["kind"] == "cache"))
def test_the_cross_cache_is_one_process_values(case, on_four_ranks):
    """``init_encdec_cache``'s (L, B, T_enc, K, dh) cross K/V, projected on
    each device's frames and gathered."""
    res, tol = _result(case, on_four_ranks)
    assert res["cross_k"] <= tol and res["cross_v"] <= tol, res
