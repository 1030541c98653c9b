"""Parallelism planner: rank (dp, tp, pp) meshes by Ridgeline step time,
copied from ``repro.launch.plan`` with ``--hardware`` defaulting to the
port's card (``h100_sxm``).

``plan(cfg, hw, chips, ...)`` is a thin slice of the grid-scale vectorized
engine in :mod:`repro_torch.launch.plan_grid` — one chips budget, one global
batch — kept as the ergonomic scalar API.  The engine enumerates every
feasible ``dp × tp × pp`` factorization (pp | n_layers) crossed with every
1F1B microbatch count (m | batch/dp) and collective algorithm, and derives
each candidate's per-chip Ridgeline terms analytically —

  F    = 6 · N_active · tokens / (dp·tp·pp)
  B_M  = params_bytes/(tp·pp) + 2 · (L/pp) · boundary_act_bytes   (per µbatch)
  t_N  = DP grad all-reduce (params_bytes/(tp·pp) over dp, once per step)
         + bubble · [ TP activation all-reduces (2×/layer MLP, 4×/layer
           attention, per stage per microbatch) + PP boundary p2p
           (2 hops · act_bytes/m) ],  each priced α–β on the *link its
           mesh axis rides*:  α(link)·steps + bytes/bandwidth(link)

— where ``bubble = (m + pp − 1)/m`` is the 1F1B pipeline-fill factor
(exactly 1 at pp = 1, recovering the non-pipelined model bit-for-bit).
Collective wire bytes and hop counts come from
``repro_torch.distributed.collectives`` under the chosen algorithm, and the whole
candidate set is evaluated in one :mod:`repro_torch.core.sweep` broadcast pass —
there is no per-candidate Python loop; grids of ≥10⁵ candidates/s are one
call (``plan_grid``).  With ``pod_size`` set, an axis whose ring extends
past one pod is priced at the ``pod`` link's (slower) bandwidth — the
slowest hop bounds a ring.  A size-1 mesh axis has no collective at all and
pays neither bytes nor α·steps.  Everything is closed-form +
the model's own ``init_*`` on fake tensors (for exact parameter counts,
memoized per config; ``launch/specs``), so planning needs no accelerator,
creates no CUDA context and runs in milliseconds.

**Algorithm selection.**  The collective *algorithm* is part of the cost
model: with a per-hop α, a log-step tree all-reduce beats rings below some
payload and a bandwidth-optimal ring wins above it.  The default
``"auto"`` picks the α–β argmin per mesh axis via
``collectives.best_all_reduce_grid`` — each candidate's dp and tp axes may
select different algorithms (``MeshPlan.dp_algo``/``tp_algo``).  A concrete
algorithm name prices every axis with it, and ``--algo all`` enumerates
every algorithm as its own ranked candidate and reports the per-axis/link
flip payloads (``flip_points``).

Calibrated specs carry a ``model_rel_error`` (median |model-vs-measured|
on whole-step validation points); each ranked plan widens its point
estimate into the uncertainty band ``[runtime·(1−e), runtime·(1+e)]``.
Their size-dependent ``compute_eff`` ceiling flows through the sweep
automatically.

CLI::

    python -m repro_torch.launch.plan --arch dlrm-mlp --chips 16
    python -m repro_torch.launch.plan --arch dlrm-mlp --chips 32 --pod-size 16
    python -m repro_torch.launch.plan --arch qwen2-7b --chips 32 --algo all
    python -m repro_torch.launch.plan --arch qwen2-7b --chips 64 --pp 8
    python -m repro_torch.launch.plan --arch qwen2-moe-a2.7b --chips 16 --ep 4
    python -m repro_torch.launch.plan --arch qwen2-7b --chips 64 --pp 8 \\
        --interleave 2
    python -m repro_torch.launch.plan --arch dlrm-mlp --chips-grid 8,16,32,64 \\
        --batch-grid 256,512,1024 --pp 4
    python -m repro_torch.launch.plan --arch dlrm-mlp --chips 16 --calibrated --json
    python -m repro_torch.launch.plan --arch qwen2-7b --chips 16 --zero auto --remat
    python -m repro_torch.launch.plan --arch qwen2-7b --chips 16 --zero auto \\
        --explain --trace artifacts/traces/plan.trace.json
    python -m repro_torch.launch.plan --arch dlrm-mlp --chips-grid 16,64 \\
        --goodput --mtbf-hours 2000
    python -m repro_torch.launch.plan --hardware list

**Memory feasibility.**  When the spec carries a per-chip
``hbm_capacity_bytes`` (datasheet presets and calibrated entries do),
every candidate's working set (``launch/memory``: params + grads +
optimizer states + in-flight activations) is priced first and candidates
that cannot fit are pruned before ranking — the planner never recommends
a mesh that cannot hold its own state.  ``--zero auto`` (or a comma list
of stages) searches ZeRO sharding as a candidate axis, ``--remat`` trades
activation footprint for +1/3 recompute FLOPs, and
``--no-capacity-check`` keeps infeasible rows marked ``fit=NO`` instead
(the what-if view).

**Failure-aware goodput.**  ``--goodput`` (implied by ``--mtbf-hours H``)
prices failures into the ranking (:mod:`repro_torch.resilience.failures`): each
candidate's persisted checkpoint bytes over the spec's ``ckpt_bw`` set its
checkpoint cost, Young/Daly sets the cadence, and the amortized per-step
checkpoint/rework/restart seconds are added to the step time before
ranking — so a smaller mesh with a cheaper failure bill can out-rank the
healthy winner.  Without ``--mtbf-hours`` the MTBF is infinite and the
ranking is bit-identical to the healthy one (goodput ≡ 1).

``--pp N`` admits pipeline axes up to N stages; ``--chips-grid`` /
``--batch-grid`` (comma lists) switch to grid mode: the whole scaling
surface in one vectorized pass, one best-plan row per grid point.
``--hardware`` accepts any name from ``core.hardware.list_hardware()``
(datasheet presets and calibrated registry entries alike; ``list`` prints
them); ``--calibrated`` swaps in the measured twin of the named preset, so
rankings use achievable rather than vendor ceilings.  ``--json`` emits the
full ranking machine-readably for scripting.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from repro_torch.core.hardware import HardwareSpec, get_hardware, list_hardware
from repro_torch.core.report import CellReport, roofline_table
from repro_torch.distributed import collectives
# the evaluation core + its vocabulary (re-exported: this module is the
# stable import surface; the engine lives in plan_grid)
from repro_torch.launch.plan_grid import (MeshPlan, PlanGrid, POD_LINK,
                                    ZERO_STAGES, feasible_meshes,
                                    param_counts, plan_grid)
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.failures import FailureModel

if TYPE_CHECKING:  # torch-backed; planning itself is numpy-only
    from repro_torch.models.config import ModelConfig

__all__ = ["MeshPlan", "PlanGrid", "plan", "plan_grid", "best_step_time",
           "feasible_meshes", "param_counts", "flip_points",
           "format_plan_table", "format_grid_table", "format_flip_table",
           "to_cell_reports", "main"]


def _axis_link(axis: int, inner: int, pod_size: Optional[int],
               hw: HardwareSpec) -> Optional[str]:
    """Link a ring over ``axis`` chips (stride ``inner``) is priced at.

    Scalar twin of the engine's boolean-mask routing, kept for the
    flip-point report: a ring whose extent ``axis·inner`` exceeds the pod
    crosses a pod boundary somewhere, and a ring runs at its slowest hop —
    so the whole axis is priced at the ``pod`` link.  Returns None
    (primary link) for intra-pod axes, trivial axes, or when no
    ``pod_size`` is given.
    """
    if pod_size is None or axis <= 1 or axis * inner <= pod_size:
        return None
    hw.bandwidth_for(POD_LINK)      # actionable KeyError if the spec has none
    return POD_LINK


def plan(cfg: ModelConfig, hw: HardwareSpec, chips: int, *,
         batch: int, seq: int = 1,
         algorithms: Sequence[str] = ("auto",),
         pod_size: Optional[int] = None,
         max_pp: int = 1, max_ep: int = 1, interleave: int = 1,
         zero_stages: Sequence[int] = (0,),
         remat: bool = False, check_capacity: bool = True,
         goodput: bool = False,
         failure: Optional["FailureModel"] = None) -> List[MeshPlan]:
    """Rank every feasible (dp, tp, pp, ep, m, algorithm) by step time.

    A single-point slice of :func:`repro_torch.launch.plan_grid.plan_grid` (one
    chips budget, one batch) — same evaluation core, same numbers.

    ``pod_size`` (chips per pod) routes each mesh axis onto the link it
    actually rides: axes contained in one pod use primary ICI, axes that
    span pods use the slower ``pod`` entry of ``hw.extra_links``.

    ``algorithms`` entries are concrete collective tags (including the
    ``bidir`` alias) or ``"auto"`` (the default): per-axis α–β argmin over
    the full menu, so the dp grad sync and the tp act syncs can pick
    different algorithms on the same candidate.  ``max_pp`` admits
    pipeline-parallel axes up to that many stages (1 = the classic
    dp × tp space); ``max_ep`` admits expert-parallel axes dividing the
    padded expert count (MoE configs only — see
    :func:`repro_torch.launch.plan_grid.plan_grid`); ``interleave`` prices the
    interleaved-1F1B schedule with that many virtual stages per chip.

    ``zero_stages``/``remat``/``check_capacity`` are the memory-feasibility
    controls (see :func:`repro_torch.launch.plan_grid.plan_grid`): when the spec
    carries an ``hbm_capacity_bytes``, candidates whose working set cannot
    fit are pruned before pricing — the returned ranking never recommends
    a mesh that cannot hold its own state.

    ``goodput``/``failure`` fold the amortized failure bill
    (checkpoint overhead + expected rework + expected restart, see
    :func:`repro_torch.launch.plan_grid.plan_grid`) into the ranked step times.
    """
    grid = plan_grid(cfg, hw, [chips], [batch], seq=seq,
                     algorithms=algorithms, pod_size=pod_size, max_pp=max_pp,
                     max_ep=max_ep, interleave=interleave,
                     zero_stages=zero_stages, remat=remat,
                     check_capacity=check_capacity,
                     goodput=goodput, failure=failure)
    return grid.plans()


def flip_points(cfg: ModelConfig, hw: HardwareSpec, chips: int, *,
                batch: int, pod_size: Optional[int] = None) -> List[dict]:
    """Per mesh axis/link: where the best all-reduce algorithm flips.

    One row per distinct (axis kind, group size, link) among the feasible
    meshes, with the α–β flip payload from
    ``collectives.all_reduce_flip_payload``: the small-payload winner
    (log-step tree once α > 0) hands over to the bandwidth-optimal ring
    at ``flip_payload_bytes``.  ``None`` flip means one algorithm dominates
    every payload (e.g. α = 0); size-1 axes run no collective and are
    skipped.  (The pp boundary p2p is a fixed 2-hop send — no algorithm
    menu, so no flip row.)
    """
    seen = set()
    rows: List[dict] = []
    for d, t in feasible_meshes(cfg, chips, batch):
        for kind, n, inner in (("dp", d, t), ("tp", t, 1)):
            link = _axis_link(n, inner, pod_size, hw)
            key = (kind, n, link)
            if n <= 1 or key in seen:
                continue
            seen.add(key)
            bw, alpha = hw.bandwidth_for(link), hw.alpha_for(link)
            flip = collectives.all_reduce_flip_payload(n, bw, alpha)
            rows.append({
                "axis": kind, "group_size": n, "link": link or "ici",
                "bandwidth": bw, "alpha": alpha,
                "flip_payload_bytes": None if flip is None else flip[0],
                "small_payload_algo": None if flip is None else flip[1],
                "large_payload_algo": None if flip is None else flip[2],
            })
    return sorted(rows, key=lambda r: (r["axis"], r["group_size"]))


def best_step_time(cfg: ModelConfig, hw: HardwareSpec, chips: int, *,
                   batch: int, seq: int = 1,
                   algorithms: Sequence[str] = ("auto",),
                   pod_size: Optional[int] = None,
                   max_pp: int = 1, max_ep: int = 1, interleave: int = 1,
                   zero_stages: Sequence[int] = (0,),
                   remat: bool = False,
                   check_capacity: bool = True) -> float:
    return plan(cfg, hw, chips, batch=batch, seq=seq,
                algorithms=algorithms, pod_size=pod_size,
                max_pp=max_pp, max_ep=max_ep, interleave=interleave,
                zero_stages=zero_stages, remat=remat,
                check_capacity=check_capacity)[0].runtime


def to_cell_reports(arch: str, plans: Sequence[MeshPlan], hw: HardwareSpec,
                    *, batch: int, tokens: float, params_total: float,
                    params_active: float) -> List[CellReport]:
    """Planner candidates as the standard per-cell report artifact.

    ``wire_bytes`` are primary-link-equivalent (``t_network · net_bw``) so
    the report's projection matches the plan's per-axis α–β pricing; the
    raw per-axis wire bytes ride along in ``wire_bytes_by_kind``.
    """
    reports = []
    for p in plans:
        rep = CellReport(
            arch=arch, shape=f"plan_b{batch}", mesh=p.mesh,
            step_kind="train_step", num_devices=p.chips, hardware=hw.name,
            flops=p.flops, mem_bytes=p.mem_bytes,
            wire_bytes=p.t_network * hw.net_bw,
            wire_bytes_by_kind={"analytic-dp+tp+pp": p.net_bytes},
            peak_memory_per_device=0.0,
            model_flops=6.0 * params_active * tokens,
            params_total=params_total, params_active=params_active,
            tokens_per_step=tokens, variant=p.algo_label,
            notes=f"rank by plan; {p.algorithm}->{p.algo_label}; links "
                  f"{p.dp_link}/{p.tp_link}"
                  + (f"; pp{p.pp} m{p.microbatches}" if p.pp > 1 else "")
                  + (f"; ep{p.ep} a2a on {p.ep_link}" if p.ep > 1 else ""))
        reports.append(rep.finalize(hw))
    return reports


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:9.3f}"


def format_plan_table(plans: Sequence[MeshPlan]) -> str:
    banded = any(p.runtime_hi > p.runtime for p in plans)
    piped = any(p.pp > 1 for p in plans)
    eped = any(p.ep > 1 for p in plans)
    zeroed = any(p.zero_stage > 0 for p in plans)
    capped = any(p.hbm_bytes > 0 for p in plans)
    misfit = any(not p.fits for p in plans)
    # a goodput-priced plan always carries a nonzero Young/Daly interval
    # (inf under an infinite MTBF); the healthy path leaves the default 0.0
    gooded = any(p.ckpt_interval_s != 0.0 for p in plans)
    head = (f"{'rank':>4} {'mesh':>12} "
            + (f"{'pp':>3} {'mb':>4} " if piped else "")
            + (f"{'ep':>3} " if eped else "")
            + (f"{'z':>2} " if zeroed else "")
            + f"{'algo':>10} {'t_comp ms':>9} "
            f"{'t_mem ms':>9} {'t_net ms':>9} {'step ms':>9} "
            + (f"{'band ms':>19} " if banded else "")
            + (f"{'gp%':>6} " if gooded else "")
            + (f"{'hbm GB':>7} " if capped else "")
            + (f"{'fit':>4} " if misfit else "")
            + f"{'links':>9} {'bottleneck':>10} {'peak%':>6}")
    lines = [head, "-" * len(head)]
    for i, p in enumerate(plans):
        band = (f"{_fmt_ms(p.runtime_lo)}..{_fmt_ms(p.runtime_hi).strip():<8} "
                if banded else "")
        pipe = f"{p.pp:>3} {p.microbatches:>4} " if piped else ""
        link = p.dp_link if p.dp_link == p.tp_link else \
            f"{p.dp_link}/{p.tp_link}"
        lines.append(
            f"{i + 1:>4} {p.mesh:>12} " + pipe
            + (f"{p.ep:>3} " if eped else "")
            + (f"{p.zero_stage:>2} " if zeroed else "")
            + f"{p.algo_label:>10} "
            f"{_fmt_ms(p.t_compute)} {_fmt_ms(p.t_memory)} "
            f"{_fmt_ms(p.t_network)} {_fmt_ms(p.runtime)} "
            + band
            + (f"{100 * p.goodput:5.1f}% " if gooded else "")
            + (f"{p.hbm_used_gb:7.1f} " if capped else "")
            + (f"{'yes' if p.fits else 'NO':>4} " if misfit else "")
            + f"{link:>9} {p.bottleneck:>10} {100 * p.peak_fraction:5.1f}%")
    return "\n".join(lines)


def format_grid_table(grid: PlanGrid, top: int = 1) -> str:
    """Grid mode: the ``top`` best plans per (chips, batch) point."""
    top = max(1, top)
    ranked = top > 1
    zeroed = any(z > 0 for z in grid.zero_stages)
    capped = grid.hbm_capacity_bytes > 0
    gooded = grid.goodput is not None
    head = (f"{'chips':>6} {'batch':>7} "
            + (f"{'rank':>4} " if ranked else "")
            + f"{'mesh':>14} {'mb':>4} "
            + (f"{'z':>2} " if zeroed else "")
            + f"{'algo':>10} {'step ms':>9} "
            + (f"{'gp%':>6} " if gooded else "")
            + (f"{'hbm GB':>7} " if capped else "")
            + f"{'bottleneck':>10} {'peak%':>6}")
    lines = [head, "-" * len(head)]
    for chips in grid.chips_list:
        for batch in grid.batch_list:
            for r, p in enumerate(grid.plans(chips, batch)[:top]):
                lines.append(
                    f"{chips:>6} {batch:>7} "
                    + (f"{r + 1:>4} " if ranked else "")
                    + f"{p.mesh:>14} {p.microbatches:>4} "
                    + (f"{p.zero_stage:>2} " if zeroed else "")
                    + f"{p.algo_label:>10} {_fmt_ms(p.runtime)} "
                    + (f"{100 * p.goodput:5.1f}% " if gooded else "")
                    + (f"{p.hbm_used_gb:7.1f} " if capped else "")
                    + f"{p.bottleneck:>10} {100 * p.peak_fraction:5.1f}%")
    return "\n".join(lines)


def format_flip_table(rows: Sequence[dict]) -> str:
    """Human-readable flip-point report (the ``--algo all`` extra)."""
    out = ["# all-reduce algorithm flip points (per mesh axis / link)"]
    if not rows:
        return "\n".join(out + ["  (no multi-chip axes)"])
    for r in rows:
        where = (f"  {r['axis']:>3} axis n={r['group_size']:<4} "
                 f"link={r['link']:<4} "
                 f"(bw {r['bandwidth']:.3g} B/s, alpha {r['alpha']:.3g} s)")
        if r["flip_payload_bytes"] is None:
            out.append(where + ": no flip (one algorithm dominates)")
        else:
            out.append(
                where + f": {r['small_payload_algo']} below "
                f"{r['flip_payload_bytes']:.4g} B, "
                f"{r['large_payload_algo']} above")
    return "\n".join(out)


def _plan_dict(p: MeshPlan) -> dict:
    return {"mesh": p.mesh, "chips": p.chips,
            "algo_label": p.algo_label, "hbm_used_gb": p.hbm_used_gb,
            **dataclasses.asdict(p)}


def _capacity_dict(grid: PlanGrid) -> dict:
    """Machine-readable summary of the feasibility cut (JSON outputs)."""
    return {
        "hbm_capacity_bytes": grid.hbm_capacity_bytes,
        "checked": grid.check_capacity,
        "n_enumerated": grid.n_enumerated,
        "n_pruned": int(grid.n_pruned.sum()),
        "pruned_fraction": grid.pruned_fraction,
        "min_zero_to_fit": grid.min_zero_to_fit.tolist(),
    }


def _failure_json(goodput: bool,
                  failure: Optional[FailureModel]) -> dict:
    """The ``failure`` block of ``--json`` output (empty when healthy).
    An infinite MTBF serializes as ``null`` to keep the JSON strict."""
    if not goodput:
        return {}
    import math
    fm = failure if failure is not None else FailureModel()
    return {"failure": {
        "mtbf_chip_s": (fm.mtbf_chip_s
                        if math.isfinite(fm.mtbf_chip_s) else None),
        "restart_s": fm.restart_s, "reshard_s": fm.reshard_s}}


def _parse_grid(arg: Optional[str], name: str) -> Optional[List[int]]:
    if arg is None:
        return None
    try:
        vals = [int(v) for v in arg.split(",") if v.strip()]
    except ValueError:
        raise ValueError(f"--{name} wants a comma list of ints, got {arg!r}")
    if not vals:
        raise ValueError(f"--{name} is empty")
    return vals


def _explain_dict(grid: PlanGrid) -> dict:
    from repro_torch.obs import explain as explain_mod
    return explain_mod.explain_dict(grid)


def _print_explain(grid: PlanGrid) -> None:
    """The --explain section: per-point tables + the machine JSON block."""
    from repro_torch.obs import explain as explain_mod
    d = explain_mod.explain_dict(grid)
    print()
    print("# --- explain: cost attribution "
          "(breakdown terms sum to step time) ---")
    for pt in d["points"]:
        print(explain_mod.format_prune_reasons(pt))
        print(explain_mod.format_explain_table(pt["candidates"]))
    print()
    print("# explain JSON")
    print(json.dumps(d, indent=1, sort_keys=True))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point: parse, plan, print; flush the tracer on the way out
    (``--trace PATH`` spans cover everything the run did, even on error)."""
    try:
        return _main(argv)
    finally:
        t = obs_trace.active()
        if t is not None and t.path:
            try:
                t.write()
            except OSError as e:
                print(f"warning: could not write trace: {e}", file=sys.stderr)


def _main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.plan",
        description="Rank (dp, tp, pp) meshes by Ridgeline-projected step "
                    "time; grid mode sweeps chips × batch in one pass.")
    ap.add_argument("--arch")
    ap.add_argument("--chips", type=int)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: 512 MLP / 256 LM)")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--hardware", default="h100_sxm",
                    help="spec name (datasheet preset or calibrated registry "
                         "entry), or 'list' to enumerate all of them")
    ap.add_argument("--calibrated", action="store_true",
                    help="use the calibrated twin of --hardware "
                         "(REPRO_TORCH_CALIBRATION_DIR, else "
                         "artifacts/calibration_torch)")
    ap.add_argument("--pod-size", type=int, default=None,
                    help="chips per pod; mesh axes spanning pods are priced "
                         "at the spec's 'pod' link instead of primary ICI")
    ap.add_argument("--pp", type=int, default=1,
                    help="max pipeline-parallel stages to search; stage "
                         "counts not dividing n_layers (or the chip "
                         "budget) are skipped, and 1F1B microbatch counts "
                         "are searched automatically (default 1 = no "
                         "pipeline axis)")
    ap.add_argument("--ep", type=int, default=1,
                    help="max expert-parallel axis size to search; ep must "
                         "divide the padded expert count E_pad = "
                         "max(n_experts, pad_experts_to), so this only "
                         "widens the space for MoE archs (default 1 = no "
                         "ep axis)")
    ap.add_argument("--interleave", type=int, default=1,
                    help="interleaved-1F1B virtual stages per chip: divides "
                         "the pipeline ramp bubble by min(N, layers/pp) at "
                         "the cost of that many times the boundary p2p "
                         "traffic (default 1 = classic 1F1B)")
    ap.add_argument("--chips-grid", default=None,
                    help="comma list of chip budgets -> grid mode "
                         "(one vectorized pass over every point)")
    ap.add_argument("--batch-grid", default=None,
                    help="comma list of global batches -> grid mode")
    ap.add_argument("--zero", default="0",
                    help="ZeRO stages to search: a comma list of 0-3, or "
                         "'auto' (all stages; stage 1/2/3 shard optimizer "
                         "states/gradients/parameters over dp). Default 0 "
                         "= no sharding")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize activations: half the saved-"
                         "activation footprint at +1/3 recompute FLOPs")
    ap.add_argument("--no-capacity-check", action="store_true",
                    help="keep candidates exceeding the spec's "
                         "hbm_capacity_bytes (marked fit=NO) instead of "
                         "pruning them — the what-if view")
    ap.add_argument("--goodput", action="store_true",
                    help="price failures into the ranking: amortized "
                         "checkpoint + rework + restart seconds (Young/Daly "
                         "cadence over the spec's ckpt_bw) are added to each "
                         "candidate's step time; without --mtbf-hours the "
                         "MTBF is infinite and the ranking is unchanged")
    ap.add_argument("--mtbf-hours", type=float, default=None,
                    help="per-chip mean time between failures, hours "
                         "(implies --goodput); the mesh fails chips x "
                         "faster")
    ap.add_argument("--restart-s", type=float, default=60.0,
                    help="seconds from failure to training again "
                         "(respawn + checkpoint read-back; default 60)")
    ap.add_argument("--reshard-s", type=float, default=30.0,
                    help="extra elastic-reshard seconds charged per "
                         "restart (default 30)")
    ap.add_argument("--algo", default="auto",
                    choices=sorted(collectives.ALGORITHM_ALIASES)
                    + list(collectives.ALGORITHMS) + ["auto", "all"],
                    help="collective algorithm: a concrete tag, 'auto' "
                         "(per-axis α–β argmin, the default), or 'all' "
                         "(rank every algorithm and report flip points)")
    ap.add_argument("--top", type=int, default=0,
                    help="show only the best N candidates (0 = all)")
    ap.add_argument("--explain", action="store_true",
                    help="decompose every candidate's step time into its "
                         "additive terms (compute/memory α vs work, per-axis "
                         "network α·steps vs bytes/bw, pipeline bubble, ZeRO "
                         "sync) plus structured prune reasons; adds an "
                         "'explain' block to --json output")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome-trace-event JSON of this run's "
                         "planner spans to PATH (loads in ui.perfetto.dev "
                         "or chrome://tracing)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output (full ranking + spec)")
    args = ap.parse_args(argv)
    if args.trace:
        obs_trace.enable(args.trace)

    if args.hardware == "list":
        specs = list_hardware()
        if args.as_json:
            print(json.dumps(
                {name: {"source": src,
                        **dataclasses.asdict(get_hardware(name))}
                 for name, src in sorted(specs.items())}, indent=1))
        else:
            print(f"{'name':>16} {'source':>12} {'peak FLOP/s':>12} "
                  f"{'HBM B/s':>10} {'NET B/s':>10}")
            for name, src in sorted(specs.items()):
                s = get_hardware(name)
                print(f"{name:>16} {src:>12} {s.peak_flops:>12.3g} "
                      f"{s.hbm_bw:>10.3g} {s.net_bw:>10.3g}")
        return 0
    grid_mode = args.chips_grid is not None or args.batch_grid is not None
    if args.arch is None or (args.chips is None and args.chips_grid is None):
        ap.error("--arch and --chips (or --chips-grid) are required "
                 "(unless --hardware list)")

    from repro_torch.configs import get_config, list_archs
    try:
        cfg = get_config(args.arch)
    except KeyError:
        print(f"unknown arch {args.arch!r}; have: {', '.join(list_archs())}",
              file=sys.stderr)
        return 2
    try:
        hw = get_hardware(args.hardware, calibrated=args.calibrated)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    batch = args.batch if args.batch is not None else (
        512 if cfg.family == "mlp" else 256)
    algos = collectives.ALGORITHMS if args.algo == "all" else (args.algo,)
    if args.zero.strip().lower() == "auto":
        zero_stages: Tuple[int, ...] = ZERO_STAGES
    else:
        try:
            zero_stages = tuple(int(v) for v in args.zero.split(",")
                                if v.strip())
        except ValueError:
            ap.error(f"--zero wants 'auto' or a comma list of stages "
                     f"0-3, got {args.zero!r}")
        if not zero_stages:
            ap.error("--zero is empty")
    check_capacity = not args.no_capacity_check
    goodput = args.goodput or args.mtbf_hours is not None
    failure = None
    if args.mtbf_hours is not None:
        if args.mtbf_hours <= 0:
            ap.error(f"--mtbf-hours must be > 0, got {args.mtbf_hours}")
        failure = FailureModel.from_mtbf_hours(
            args.mtbf_hours, restart_s=args.restart_s,
            reshard_s=args.reshard_s)

    if grid_mode:
        try:
            chips_list = _parse_grid(args.chips_grid, "chips-grid") \
                or [args.chips]
            batch_list = _parse_grid(args.batch_grid, "batch-grid") or [batch]
            grid = plan_grid(cfg, hw, chips_list, batch_list, seq=args.seq,
                             algorithms=algos, pod_size=args.pod_size,
                             max_pp=args.pp, max_ep=args.ep,
                             interleave=args.interleave,
                             zero_stages=zero_stages,
                             remat=args.remat,
                             check_capacity=check_capacity,
                             explain=args.explain,
                             goodput=goodput, failure=failure)
        except (ValueError, KeyError) as e:
            print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
            return 2
        # flip points across the whole grid, deduped by (axis, n, link)
        flip_rows = {}
        for c in grid.chips_list:
            for b in grid.batch_list:
                for r in flip_points(cfg, hw, c, batch=b,
                                     pod_size=args.pod_size):
                    flip_rows[(r["axis"], r["group_size"], r["link"])] = r
        flips = [flip_rows[k] for k in sorted(flip_rows)]
        if args.as_json:
            def point_dict(c: int, b: int) -> dict:
                pts = grid.plans(c, b)
                d = {"chips": c, "batch": b, "best": _plan_dict(pts[0])}
                if args.top:
                    d["plans"] = [_plan_dict(p) for p in pts[:args.top]]
                return d

            print(json.dumps({
                "mode": "grid", "arch": args.arch,
                "chips_grid": list(grid.chips_list),
                "batch_grid": list(grid.batch_list),
                "seq": None if cfg.family == "mlp" else args.seq,
                "pod_size": args.pod_size, "max_pp": args.pp,
                "max_ep": args.ep, "interleave": args.interleave,
                "algo": args.algo, "algorithms": list(algos),
                "zero_stages": list(grid.zero_stages),
                "remat": grid.remat,
                "capacity": _capacity_dict(grid),
                **_failure_json(goodput, failure),
                "n_candidates": grid.n_candidates,
                "flip_points": flips,
                "hardware": {"source": "calibrated" if args.calibrated
                             else list_hardware().get(hw.name, "datasheet"),
                             **dataclasses.asdict(hw)},
                "points": [point_dict(c, b) for c in grid.chips_list
                           for b in grid.batch_list],
                **({"explain": _explain_dict(grid)} if args.explain else {}),
            }, indent=1))
            return 0
        print(f"# {args.arch} grid on {hw.name}: "
              f"chips {list(grid.chips_list)} x batch {list(grid.batch_list)}"
              + ("" if cfg.family == "mlp" else f", seq={args.seq}")
              + f", algo={args.algo}, max_pp={args.pp}"
              + (f", max_ep={args.ep}" if args.ep > 1 else "")
              + (f", interleave={args.interleave}"
                 if args.interleave > 1 else "")
              + (f", zero={args.zero}" if args.zero != "0" else "")
              + (", remat" if args.remat else "")
              + ((f", goodput (mtbf {args.mtbf_hours:g} h/chip)"
                  if args.mtbf_hours is not None else ", goodput")
                 if goodput else "")
              + f" ({grid.n_candidates} candidates, one pass)")
        if grid.hbm_capacity_bytes > 0 and grid.check_capacity \
                and grid.n_pruned.sum():
            print(f"# capacity {grid.hbm_capacity_bytes / 1e9:.1f} GB/chip: "
                  f"{int(grid.n_pruned.sum())} of {grid.n_enumerated} "
                  f"candidates infeasible, pruned before pricing")
        print(format_grid_table(grid, top=args.top or 1))
        if args.algo in ("all", "auto"):
            print()
            print(format_flip_table(flips))
        if args.explain:
            _print_explain(grid)
        return 0

    try:
        grid = plan_grid(cfg, hw, [args.chips], [batch], seq=args.seq,
                         algorithms=algos, pod_size=args.pod_size,
                         max_pp=args.pp, max_ep=args.ep,
                         interleave=args.interleave,
                         zero_stages=zero_stages,
                         remat=args.remat, check_capacity=check_capacity,
                         explain=args.explain,
                         goodput=goodput, failure=failure)
        plans = grid.plans()
        flips = flip_points(cfg, hw, args.chips, batch=batch,
                            pod_size=args.pod_size)
    except (ValueError, KeyError) as e:
        print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
        return 2
    shown = plans[:args.top] if args.top else plans
    tokens = float(batch) if cfg.family == "mlp" else float(batch) * args.seq
    if args.as_json:
        print(json.dumps({
            "arch": args.arch, "chips": args.chips, "batch": batch,
            "seq": None if cfg.family == "mlp" else args.seq,
            "pod_size": args.pod_size,
            "max_pp": args.pp,
            "max_ep": args.ep,
            "interleave": args.interleave,
            "algo": args.algo,
            "algorithms": list(algos),
            "zero_stages": list(grid.zero_stages),
            "remat": grid.remat,
            "capacity": _capacity_dict(grid),
            **_failure_json(goodput, failure),
            "flip_points": flips,
            "hardware": {"source": "calibrated" if args.calibrated
                         else list_hardware().get(hw.name, "datasheet"),
                         **dataclasses.asdict(hw)},
            "plans": [_plan_dict(p) for p in shown],
            "best": _plan_dict(plans[0]),
            **({"explain": _explain_dict(grid)} if args.explain else {}),
        }, indent=1))
        return 0
    print(f"# {args.arch} on {args.chips}x {hw.name}, "
          f"batch={batch}"
          + ("" if cfg.family == "mlp" else f", seq={args.seq}")
          + f", algo={args.algo}"
          + (f", max_pp={args.pp}" if args.pp > 1 else "")
          + (f", max_ep={args.ep}" if args.ep > 1 else "")
          + (f", interleave={args.interleave}" if args.interleave > 1
             else "")
          + (f", zero={args.zero}" if args.zero != "0" else "")
          + (", remat" if args.remat else "")
          + ((f", goodput (mtbf {args.mtbf_hours:g} h/chip)"
              if args.mtbf_hours is not None else ", goodput")
             if goodput else ""))
    print(format_plan_table(shown))
    if args.algo in ("all", "auto"):
        print()
        print(format_flip_table(flips))
    n_total, n_active = param_counts(cfg)
    print()
    print(roofline_table(to_cell_reports(
        args.arch, shown, hw, batch=batch, tokens=tokens,
        params_total=n_total, params_active=n_active)))
    best = plans[0]
    band = (f" (band {best.runtime_lo * 1e3:.3f}..{best.runtime_hi * 1e3:.3f}"
            f" ms from measured_rel_error)"
            if best.runtime_hi > best.runtime else "")
    bubble = (f", pp{best.pp} m{best.microbatches} "
              f"({100 * best.bubble_fraction:.0f}% bubble)"
              if best.pp > 1 else "")
    zero_note = f", ZeRO-{best.zero_stage}" if best.zero_stage else ""
    ep_note = (f", ep{best.ep} (dispatch a2a on {best.ep_link})"
               if best.ep > 1 else "")
    good_note = (f", goodput {100 * best.goodput:.1f}% "
                 f"(ckpt {best.ckpt_overhead_s * 1e3:.3f} + rework "
                 f"{best.rework_s * 1e3:.3f} + restart "
                 f"{best.restart_s * 1e3:.3f} ms/step)"
                 if best.ckpt_interval_s != 0.0 else "")
    print(f"\nbest: {best.mesh} ({best.algo_label}) -> "
          f"{best.runtime * 1e3:.3f} ms/step, {best.bottleneck}-bound"
          f"{zero_note}{ep_note}{bubble}{band}{good_note}")
    if grid.hbm_capacity_bytes > 0:
        cap_gb = grid.hbm_capacity_bytes / 1e9
        note = (f"capacity: best uses {best.hbm_used_gb:.1f} of "
                f"{cap_gb:.1f} GB/chip")
        pruned = int(grid.n_pruned.sum())
        if pruned:
            note += (f"; {pruned} of {grid.n_enumerated} candidates "
                     f"infeasible, pruned")
        k = int(grid.min_zero_to_fit[0, 0])
        if grid.check_capacity and 0 < k <= 3:
            note += f"; infeasible without ZeRO-{k}"
        print(note)
    if args.explain:
        _print_explain(grid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
