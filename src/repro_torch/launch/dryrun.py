"""Multi-pod dry-run: lower every (arch x shape x mesh) cell on a fake mesh.

The port of ``repro.launch.dryrun``.  The reference AOT-lowers and compiles
each step over 512 placeholder host devices and reads XLA's per-device cost
analysis.  Here "lowering" runs the real step once, eagerly, on fake
DTensors over a ``"fake"`` process group of the mesh's size
(``launch.mesh.fake_mesh``): no tensor holds memory and no collective moves
a byte.  For each cell it

  1. builds the production mesh (16x16 single pod / 2x16x16 multi-pod, or
     any AxB split) on the fake backend,
  2. binds GQA-safe logical sharding rules (``_rules_for``),
  3. lays the state, the batch and the cache out by their logical specs
     (``launch.specs``) and runs ``train.loop.build_train_step``'s step
     (train shapes), ``forward`` (prefill) or ``serve_step`` (decode) under
     ``measure.counters.MeshCounter``,
  4. records what one device does: F and B_M of the local shards' ops, the
     collectives' wire bytes by kind (the reference's ring factors) and
     across pods, and the peak live bytes of the shards,
  5. places the cell on the Ridgeline of ``H100_SXM`` (``CellReport``),
  6. writes the report JSON under ``artifacts/dryrun_torch/``.

Depth.  The reference probes k = 2 and 4 unrolled layers and fits
cost(L) = a + b L, because XLA counts a scanned body once.  The port has no
scan and could count the full depth; it keeps the fit because a step's
cost is linear in its layers and two shallow runs are faster than one
deep one (``probe=False`` counts the full depth; a test holds the fit to
it).  Peak memory is fitted the same way.

Families.  Every family lowers: each cell that ``configs.shapes.applicable``
assigns.  ``--all`` counts a cell that raises as a failure, as the
reference counts a cell that does not compile.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

Reports are cached by cell key; ``--force`` lowers again.  Each cell's line
gives its wire bytes by kind and, where ``--out`` holds the same cell's
1x1 report, the F of all its devices against that one device's F (lower
``--mesh 1x1`` first to have them).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.core import H100_SXM, CellReport, StepCosts, make_cell_report
from repro_torch.distributed.sharding import gqa_safe_rules, use_sharding
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import PRODUCTION, axis_sizes, fake_mesh
from repro_torch.measure.counters import MeshCounter
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
POD_SIZE = 256

#: params above this count get FSDP (param DP-sharding) in the baseline
FSDP_THRESHOLD = 8e9

def _mesh_from_name(mesh_name: str) -> Tuple[Tuple[int, ...],
                                             Tuple[str, ...]]:
    """"16x16" / "2x16x16" are the production contract; other "AxB" splits
    of the same chips are variants (e.g. "64x4": trade TP degree for DP
    when head counts don't divide 16).  Returns (shape, axis names)."""
    if mesh_name == "2x16x16":
        return PRODUCTION[True]
    if mesh_name == "16x16":
        return PRODUCTION[False]
    dims = tuple(int(d) for d in mesh_name.split("x"))
    if len(dims) != 2:
        raise ValueError(f"mesh {mesh_name!r}: want AxB, 16x16 or 2x16x16")
    return dims, ("data", "model")


def _lowering_mesh(dims: Tuple[int, ...], axes: Tuple[str, ...]
                   ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The mesh a cell lowers on: a two-pod mesh as (pod x data) x model,
    e.g. 2x16x16 as 32x16.  The ranks along the merged axis are the
    reference's ("pod", "data") groups, rank for rank, so the batch shards
    32 ways as the reference's does and each group's cross-pod share is
    read from its ranks; but DTensor plans a redistribution on a
    three-axis mesh by a search that takes minutes per layer."""
    if axes[0] != "pod":
        return dims, axes
    return (dims[0] * dims[1],) + dims[2:], axes[1:]


def _prepare_cfg(cfg: ModelConfig, shape: ShapeSpec,
                 overrides: Optional[Dict[str, Any]] = None) -> ModelConfig:
    if cfg.pos_emb == "learned" and cfg.max_seq_len < shape.seq_len:
        cfg = cfg.replace(max_seq_len=shape.seq_len)
    if shape.kind == "train" and cfg.family not in ("mlp",):
        # baseline: full remat, as the reference's (its 16 GiB budget)
        cfg = cfg.replace(remat="full")
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _rules_for(cfg: ModelConfig, mesh, shape: ShapeSpec):
    """The reference's rules for a cell, on a ``DeviceMesh`` or an
    ``AbstractMesh`` (its comments say why each one)."""
    rules = gqa_safe_rules(cfg.n_kv_heads, mesh)
    model_size = axis_sizes(mesh).get("model", 1)
    if shape.kind == "train":
        # Megatron-SP-style: residual-stream activations shard their seq
        # axis over the model axis
        rules["seq"] = "model"
    if cfg.n_heads and cfg.n_heads % model_size:
        # heads don't divide the TP axis (smollm 9H, qwen2-7b 28H, hymba
        # 25H): sequence-parallel activations so the O(S^2) scores shard
        rules["heads"] = None
        rules["q_proj"] = None
        rules["seq"] = "model"
        rules["attn_seq"] = "model"
    if shape.kind == "decode":
        # decode memory = KV cache: shard its SEQ axis over the model axis
        rules["kv_seq"] = "model"
        rules["head_dim"] = None
    if shape.kind != "train" and shape.global_batch < 16:
        # long_500k has global_batch=1: nothing to shard on data
        rules["batch"] = None
    # MoE: EP when the (padded) expert count divides the model axis;
    # otherwise TP the per-expert hidden dim
    e_eff = max(cfg.n_experts, cfg.pad_experts_to)
    if cfg.n_experts and e_eff % model_size:
        rules["experts"] = None
        rules["expert_ffn"] = "model"
    return rules


@dataclasses.dataclass
class Lowered:
    """What one run of a step on a device counted."""

    flops: float
    mem_bytes: float
    wire_bytes: float
    wire_bytes_by_kind: Dict[str, float]
    cross_pod_wire_bytes: float
    peak_memory_per_device: float

    @staticmethod
    def of(counter: MeshCounter) -> "Lowered":
        s = counter.summary
        return Lowered(counter.flops, counter.bytes, s.total_wire_bytes,
                       {k: b for k, (_, b) in s.by_kind().items()},
                       s.cross_pod_wire_bytes, float(counter.peak))


def _run(fn, args, fake_mode, pod_size: int) -> Lowered:
    """``fn(*args)`` once under a ``MeshCounter``, the args held live."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = MeshCounter(fake_mode=fake_mode, pod_size=pod_size)
    counter.hold(args)
    with implicit_replication(), counter:
        out = fn(*args)
    del out
    return Lowered.of(counter)


def _lower_one(cfg: ModelConfig, shape: ShapeSpec, mesh, pod_size: int
               ) -> Tuple[Lowered, str]:
    if shape.kind == "train":
        return _lower_train(cfg, shape, mesh, pod_size=pod_size)
    if shape.kind == "prefill":
        return _lower_prefill(cfg, shape, mesh, pod_size)
    return _lower_decode(cfg, shape, mesh, pod_size)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    # DTensor's redistributions index the shards with small real tensors
    return FakeTensorMode(allow_non_fake_inputs=True)


def _lower_train(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 zero1: bool = True, fsdp: Optional[bool] = None,
                 n_micro: int = 1, pod_size: int = 0
                 ) -> Tuple[Lowered, str]:
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.train.loop import TrainStepConfig, build_train_step
    opt = AdamW(learning_rate=1e-3)
    train_step = build_train_step(cfg, opt, TrainStepConfig(n_micro=n_micro))
    if fsdp is None:
        total, _ = sp.param_counts(cfg)
        fsdp = total > FSDP_THRESHOLD
    fm = _fake_mode()
    with fm:
        state = sp.attach(sp.abstract_train_state(cfg, opt),
                          sp.train_state_specs(cfg, zero1=zero1, fsdp=fsdp),
                          mesh)
        batch = sp.input_specs(cfg, shape, mesh)
    return _run(train_step, (state, batch), fm, pod_size), "train_step"


def _bf16(tree):
    """Serving runs from bf16 weights (production standard): halves the
    per-device parameter footprint of the decode/prefill cells."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, tree)


def _serving_params(cfg: ModelConfig, mesh, fm):
    from repro_torch.train.loop import model_param_specs
    with fm:
        return _bf16(sp.attach(sp.abstract_params(cfg),
                               model_param_specs(cfg), mesh))


def _lower_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   pod_size: int = 0) -> Tuple[Lowered, str]:
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import mlp_dlrm as mlp_mod
    from repro_torch.models import transformer as lm_mod
    from repro_torch.models import vlm as vlm_mod
    fm = _fake_mode()
    params = _serving_params(cfg, mesh, fm)
    with fm:
        batch = sp.input_specs(cfg, shape, mesh)
    if cfg.family == "mlp":
        fn = lambda p, b: mlp_mod.forward(p, b["features"], cfg)
    elif cfg.family == "encdec":
        fn = lambda p, b: encdec_mod.forward(p, b["tokens"], b["frames"],
                                             cfg)[0]
    elif cfg.family == "vlm":
        fn = lambda p, b: vlm_mod.forward(p, b["tokens"], b["patches"],
                                          cfg)[0]
    else:
        fn = lambda p, b: lm_mod.forward(p, b["tokens"], cfg)[0]
    with torch.no_grad():
        return _run(fn, (params, batch), fm, pod_size), "prefill_step"


def _lower_decode(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  pod_size: int = 0) -> Tuple[Lowered, str]:
    """One decode step against a cache of ``seq_len``; the mlp family has
    no cache, and serves one request batch by its forward (the prefill
    lowering at the decode shape's batch)."""
    if cfg.family == "mlp":
        return _lower_prefill(cfg, shape, mesh, pod_size)[0], "serve_step"
    from repro_torch.serve import engine as serve_engine
    fm = _fake_mode()
    params = _serving_params(cfg, mesh, fm)
    with fm:
        cache_abs = sp.abstract_cache(cfg, sp.abstract_params(cfg), shape)
        cache = sp.attach(cache_abs, sp.cache_logical_specs(cfg, cache_abs),
                          mesh)
        dec = sp.decode_input_specs(cfg, shape, mesh)
    serve_step = serve_engine.build_serve_step(cfg)
    with torch.no_grad():
        return _run(lambda p, t, c: serve_step(p, t, c, dec["pos"]),
                    (params, dec["tokens"], cache), fm, pod_size), \
            "serve_step"


def _probe_cfg(cfg: ModelConfig, k: int) -> ModelConfig:
    """k-layer config for cost probing (layers homogeneous)."""
    kw: Dict[str, Any] = dict(n_layers=k, slstm_layers=(),
                              global_attn_layers=())
    if cfg.family == "encdec":
        kw["encoder_layers"] = k
    return cfg.replace(**kw)


def probe_costs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                pod_size: int) -> Lowered:
    """Lower k = 2 and 4 layers, fit cost(L) = a + b L for every count
    (F, B_M, wire bytes by kind and across pods, peak bytes), and read it
    at the full depth: ``a`` is the layer-independent part (embedding,
    logits and loss, the optimizer's fixed work), ``b`` one layer's."""
    lo, hi = (_lower_one(_probe_cfg(cfg, k), shape, mesh, pod_size)[0]
              for k in (2, 4))
    L = cfg.n_layers

    def fit(c2: float, c4: float) -> float:
        b = (c4 - c2) / 2.0
        return max(c2 - 2.0 * b + b * L, 0.0)

    kinds = {k: fit(lo.wire_bytes_by_kind.get(k, 0.0),
                    hi.wire_bytes_by_kind.get(k, 0.0))
             for k in set(lo.wire_bytes_by_kind) | set(hi.wire_bytes_by_kind)}
    return Lowered(
        fit(lo.flops, hi.flops), fit(lo.mem_bytes, hi.mem_bytes),
        sum(kinds.values()), kinds,
        fit(lo.cross_pod_wire_bytes, hi.cross_pod_wire_bytes),
        fit(lo.peak_memory_per_device, hi.peak_memory_per_device))


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               variant: str = "baseline",
               overrides: Optional[Dict[str, Any]] = None,
               probe: bool = True,
               rules_overrides: Optional[Dict[str, Any]] = None
               ) -> Tuple[CellReport, Lowered]:
    """Lower one cell; returns (CellReport, the per-device counts).

    With ``probe`` (and a family whose depth is ``n_layers``) the counts are
    the k = 2, 4 fit read at the full depth; without, the full depth runs.
    """
    shape = SHAPES[shape_name]
    cfg = _prepare_cfg(get_config(arch), shape, overrides)
    dims, axes = _mesh_from_name(mesh_name)
    pod_size = POD_SIZE if "pod" in axes else 0
    t0 = time.time()
    with fake_mesh(*_lowering_mesh(dims, axes)) as mesh:
        rules = _rules_for(cfg, mesh, shape)
        if rules_overrides:
            rules.update(rules_overrides)
        with use_sharding(mesh, rules):
            if probe and cfg.family != "mlp":
                low = probe_costs(cfg, shape, mesh, pod_size)
                note = "costs=probe-fit(k=2,4)"
            else:
                low = _lower_one(cfg, shape, mesh, pod_size)[0]
                note = "costs=full-depth"
    wall = time.time() - t0
    step_kind = {"train": "train_step", "prefill": "prefill_step",
                 "decode": "serve_step"}[shape.kind]
    if pod_size:
        note += f";cross_pod={low.cross_pod_wire_bytes / 1e9:.3f}GB"
    total, active = sp.param_counts(cfg)
    costs = StepCosts(
        flops=low.flops, mem_bytes=low.mem_bytes, wire_bytes=low.wire_bytes,
        wire_bytes_by_kind=low.wire_bytes_by_kind,
        peak_memory_per_device=low.peak_memory_per_device,
        num_devices=math.prod(dims))
    report = make_cell_report(
        arch=arch, shape=shape_name, mesh=mesh_name, step_kind=step_kind,
        costs=costs, hw=H100_SXM, model_flops=sp.model_flops(cfg, shape),
        params_total=total, params_active=active,
        tokens_per_step=(shape.global_batch * shape.seq_len
                         if shape.kind != "decode" else shape.global_batch),
        variant=variant, wall_compile_s=wall, notes=note)
    return report, low


def run_cell(arch: str, shape_name: str, mesh_name: str, force: bool = False,
             variant: str = "baseline",
             overrides: Optional[Dict[str, Any]] = None,
             rules_overrides: Optional[Dict[str, Any]] = None,
             out_dir: str = ARTIFACTS) -> CellReport:
    path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_name}__{variant}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return CellReport.from_json(f.read())
    report, _ = lower_cell(arch, shape_name, mesh_name, variant=variant,
                           overrides=overrides,
                           rules_overrides=rules_overrides)
    report.save(out_dir)
    return report


def _against_one_device(rep: CellReport, out_dir: str) -> str:
    """The wire by kind, and F x N against the same cell's F at 1x1 where
    ``out_dir`` holds that report (lower ``--mesh 1x1`` first)."""
    kinds = ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                      sorted(rep.wire_bytes_by_kind.items())) or "none"
    one = os.path.join(out_dir, f"{rep.arch}__{rep.shape}__1x1__"
                                f"{rep.variant}.json")
    if rep.mesh == "1x1" or not os.path.exists(one):
        return f" ({kinds})"
    with open(one) as f:
        f1 = CellReport.from_json(f.read()).flops
    return (f" ({kinds}); F x N / F(1x1) "
            f"{rep.flops * rep.num_devices / f1:.4f}")


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v.lower(), v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="16x16",
                    help="16x16 | 2x16x16 | both | any AxB split (variants)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="ModelConfig override, e.g. --set attn_impl=chunked")
    ap.add_argument("--rule", action="append", default=[], metavar="K=V",
                    help="sharding-rule override, e.g. --rule seq=none")
    ap.add_argument("--out", default=ARTIFACTS,
                    help="report directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)

    overrides = {k: _coerce(v) for k, v in
                 (kv.split("=", 1) for kv in args.set)} or None
    rules_ov = {k: (None if v.lower() == "none" else v)
                for k, v in (kv.split("=", 1) for kv in args.rule)} or None

    meshes = ["16x16", "2x16x16"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED for s in SHAPES
                 if applicable(get_config(a).family, s)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = []
    for mesh_name in meshes:
        for arch, shape_name in cells:
            key = f"{arch} x {shape_name} x {mesh_name}"
            try:
                t0 = time.time()
                rep = run_cell(arch, shape_name, mesh_name, force=args.force,
                               variant=args.variant, overrides=overrides,
                               rules_overrides=rules_ov, out_dir=args.out)
                print(f"[OK {time.time() - t0:7.1f}s] {key}: "
                      f"{rep.bottleneck}-bound, runtime {rep.runtime:.3e}s, "
                      f"{100 * rep.peak_fraction:.1f}% peak, "
                      f"mem/dev {rep.peak_memory_per_device / 2**30:.2f} GiB, "
                      f"wire/dev {rep.wire_bytes / 1e9:.4f} GB"
                      + _against_one_device(rep, args.out), flush=True)
            except Exception as e:  # noqa: BLE001 — report all cell failures
                failures.append((key, repr(e)))
                traceback.print_exc()
                print(f"[FAIL] {key}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for k, e in failures:
            print(f"  {k}: {e}")
        return 1
    print(f"\nall {len(cells) * len(meshes)} cells OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
