"""Cost attribution: decompose every planner candidate's projected step time
(copied from ``repro.obs.explain``).

The planner ranks meshes by ``t_step = max(t_C, t_M, t_N)`` — a number
with no account of *why*.  This layer turns a ``plan_grid(...,
explain=True)`` result into an explanation:

  * per candidate, the full term decomposition — compute α + FLOP time,
    memory α + byte time, and the network side split per mesh axis into
    its α·steps (latency) and bytes/bw (bandwidth) parts, with the dp
    terms relabeled ``zero_sync`` when ZeRO's structural reduce-scatter +
    all-gather replaces the plain gradient all-reduce, and an
    ``ep_dispatch`` entry for the expert-parallel dispatch + combine
    all-to-all (zero on every ep = 1 candidate) — plus the 1F1B
    pipeline-bubble share of the step (interleaving shrinks the ramp by
    the candidate's virtual-stage count);
  * per candidate, a ``breakdown`` dict whose values **sum to the priced
    t_step** (property-tested): the additive parts of whichever resource
    bound the candidate.  The bubble is *not* one of those addends — it
    is an overlapping decomposition along the schedule axis
    (``runtime · (pp−1)/(m+pp−1)``), reported alongside;
  * per grid point, structured prune reasons: how many raw mesh tuples
    the enumeration rejected (batch/head divisibility, pp ∤ n_layers,
    the m ≥ pp 1F1B clamp) and how many enumerated candidates the
    HBM-capacity mask cut, with the ``min_zero_to_fit`` counterfactual
    ("this point is infeasible without ZeRO-k").

Everything here is a pure function of the grid — deterministic, so the
qwen2-7b explain JSON is golden-pinned (``tests/golden/explain_*.json``).
CLI surface: ``python -m repro_torch.launch.plan ... --explain [--json]``.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.launch.plan_grid import PlanGrid

__all__ = ["EXPLAIN_SCHEMA", "explain_candidates", "explain_point",
           "explain_dict", "format_explain_table"]

EXPLAIN_SCHEMA = "repro.explain/v2"


def _require_terms(grid: "PlanGrid") -> None:
    if grid.explain_terms is None:
        raise ValueError(
            "grid carries no attribution terms; re-run plan_grid(..., "
            "explain=True) (CLI: --explain)")


def _ranked_indices(grid: "PlanGrid", chips: Optional[int],
                    batch: Optional[int]) -> List[int]:
    """Candidate indices of one grid point in ``PlanGrid.plans`` order."""
    idx = grid.point_indices(chips, batch)
    return sorted(idx.tolist(),
                  key=lambda i: (grid.runtime[i], grid.tp[i], grid.zero[i]))


def explain_candidates(grid: "PlanGrid", chips: Optional[int] = None,
                       batch: Optional[int] = None) -> List[Dict]:
    """Ranked per-candidate term decompositions for one grid point.

    Row order matches ``grid.plans(chips, batch)``.  Each record's
    ``breakdown`` values sum to ``runtime`` (within float tolerance —
    the addition order differs from the engine's fused broadcast pass);
    ``terms`` carries the full attribution regardless of the bound.
    """
    _require_terms(grid)
    t = grid.explain_terms
    labels = grid.labels()
    from repro_torch.distributed import collectives
    algs = collectives.ALGORITHMS
    out = []
    for i in _ranked_indices(grid, chips, batch):
        dp, tp, pp = int(grid.dp[i]), int(grid.tp[i]), int(grid.pp[i])
        ep, vs = int(grid.ep[i]), int(grid.vstages[i])
        m, zero = int(grid.microbatches[i]), int(grid.zero[i])
        bound = str(labels[i])
        runtime = float(grid.runtime[i])
        # interleaving divides the ramp by vstages; the vs = 1 branch keeps
        # the classic integer expression (and its exact JSON rendering)
        ramp = (pp - 1) / vs if vs > 1 else pp - 1
        fill = m + ramp
        dp_kind = "zero_sync" if zero >= 1 else "all_reduce"
        dp_algo = ("-" if dp <= 1 else
                   ("rs+ag" if zero >= 1 else algs[int(grid.dp_algo_idx[i])]))
        tp_algo = "-" if tp <= 1 else algs[int(grid.tp_algo_idx[i])]
        net = {
            "dp": {"kind": dp_kind, "algo": dp_algo,
                   "link": "pod" if grid.dp_pod[i] else "ici",
                   "alpha_steps": float(t.net_dp_alpha_s[i]),
                   "bytes_over_bw": float(t.net_dp_bytes_s[i]),
                   "total": float(t.net_dp_alpha_s[i] + t.net_dp_bytes_s[i])},
            "tp": {"kind": "all_reduce", "algo": tp_algo,
                   "link": "pod" if grid.tp_pod[i] else "ici",
                   "alpha_steps": float(t.net_tp_alpha_s[i]),
                   "bytes_over_bw": float(t.net_tp_bytes_s[i]),
                   "total": float(t.net_tp_alpha_s[i] + t.net_tp_bytes_s[i])},
            "pp": {"kind": "p2p", "algo": "-" if pp <= 1 else "send",
                   "link": "pod" if grid.pp_pod[i] else "ici",
                   "alpha_steps": float(t.net_pp_alpha_s[i]),
                   "bytes_over_bw": float(t.net_pp_bytes_s[i]),
                   "total": float(t.net_pp_alpha_s[i] + t.net_pp_bytes_s[i])},
            "ep": {"kind": "ep_dispatch", "algo": "-" if ep <= 1 else "a2a",
                   "link": "pod" if grid.ep_pod[i] else "ici",
                   "alpha_steps": float(t.net_ep_alpha_s[i]),
                   "bytes_over_bw": float(t.net_ep_bytes_s[i]),
                   "total": float(t.net_ep_alpha_s[i] + t.net_ep_bytes_s[i])},
        }
        bubble_s = runtime * ramp / fill
        if bound == "compute":
            breakdown = {"compute_alpha": float(t.comp_alpha_s[i]),
                         "compute_flops": float(t.comp_flops_s[i])}
        elif bound == "memory":
            breakdown = {"memory_alpha": float(t.mem_alpha_s[i]),
                         "memory_bytes": float(t.mem_bytes_s[i])}
        else:
            dp_tag = "zero_sync" if zero >= 1 else "dp_sync"
            breakdown = {
                f"{dp_tag}_alpha": net["dp"]["alpha_steps"],
                f"{dp_tag}_bytes": net["dp"]["bytes_over_bw"],
                "tp_sync_alpha": net["tp"]["alpha_steps"],
                "tp_sync_bytes": net["tp"]["bytes_over_bw"],
                "pp_p2p_alpha": net["pp"]["alpha_steps"],
                "pp_p2p_bytes": net["pp"]["bytes_over_bw"],
                "ep_dispatch_alpha": net["ep"]["alpha_steps"],
                "ep_dispatch_bytes": net["ep"]["bytes_over_bw"],
            }
        goodput_rec = {}
        if grid.goodput is not None:
            # goodput pricing folded the failure bill into runtime, so the
            # breakdown gains the three amortized terms to keep summing to
            # the (effective) step time the ranking used
            breakdown["ckpt_overhead_s"] = float(grid.ckpt_overhead_s[i])
            breakdown["rework_s"] = float(grid.rework_s[i])
            breakdown["restart_s"] = float(grid.restart_s[i])
            goodput_rec = {"goodput": {
                "fraction": float(grid.goodput[i]),
                "ckpt_interval_s": float(grid.ckpt_interval_s[i]),
                "ckpt_overhead_s": float(grid.ckpt_overhead_s[i]),
                "rework_s": float(grid.rework_s[i]),
                "restart_s": float(grid.restart_s[i]),
            }}
        out.append({
            "mesh": (f"dp{dp}xtp{tp}" + (f"xpp{pp}" if pp > 1 else "")
                     + (f"xep{ep}" if ep > 1 else "")),
            "dp": dp, "tp": tp, "pp": pp, "ep": ep, "microbatches": m,
            "vstages": vs,
            "zero_stage": zero, "remat": bool(grid.remat),
            "algorithm": grid.algorithms[int(grid.req_idx[i])],
            "dp_algo": dp_algo, "tp_algo": tp_algo,
            "bottleneck": bound, "runtime": runtime,
            "t_compute": float(grid.t_compute[i]),
            "t_memory": float(grid.t_memory[i]),
            "t_network": float(grid.t_network[i]),
            "hbm_bytes": float(grid.hbm_bytes[i]),
            "terms": {
                "compute": {"alpha": float(t.comp_alpha_s[i]),
                            "flops": float(t.comp_flops_s[i])},
                "memory": {"alpha": float(t.mem_alpha_s[i]),
                           "bytes": float(t.mem_bytes_s[i])},
                "network": net,
            },
            "pipeline_bubble": {"fill": fill,
                                "fraction": ramp / fill,
                                "seconds": bubble_s},
            **goodput_rec,
            "breakdown": breakdown,
        })
    return out


def explain_point(grid: "PlanGrid", chips: Optional[int] = None,
                  batch: Optional[int] = None) -> Dict:
    """One grid point: prune reasons + ranked candidate decompositions."""
    _require_terms(grid)
    ci, bi = grid._point(chips, batch)
    reasons = dict(grid.prune_reasons[(ci, bi)])
    reasons["capacity"] = int(grid.n_pruned[ci, bi])
    k = int(grid.min_zero_to_fit[ci, bi])
    return {
        "chips": int(grid.chips_list[ci]),
        "batch": int(grid.batch_list[bi]),
        "prune_reasons": reasons,
        "min_zero_to_fit": k if 0 <= k <= 3 else None,
        "candidates": explain_candidates(grid, chips, batch),
    }


def explain_dict(grid: "PlanGrid") -> Dict:
    """The full machine-readable explanation of one ``plan_grid`` pass.

    Pure function of the grid (no clocks, no provenance) so the output is
    deterministic and golden-pinnable.
    """
    _require_terms(grid)
    return {
        "schema": EXPLAIN_SCHEMA,
        "arch": grid.cfg_name,
        "hardware": grid.hardware,
        "seq": grid.seq,
        "pod_size": grid.pod_size,
        "max_pp": grid.max_pp,
        "max_ep": grid.max_ep,
        "interleave": grid.interleave,
        "algorithms": list(grid.algorithms),
        "zero_stages": list(grid.zero_stages),
        "remat": bool(grid.remat),
        "capacity": {
            "hbm_capacity_bytes": float(grid.hbm_capacity_bytes),
            "checked": bool(grid.check_capacity),
            "n_enumerated": int(grid.n_enumerated),
            "n_pruned": int(grid.n_pruned.sum()),
            "pruned_fraction": float(grid.pruned_fraction),
        },
        # only a goodput-priced grid carries a failure model; the healthy
        # path keeps the committed explain goldens key-for-key identical
        **({"failure": {
            "mtbf_chip_s": (float(grid.failure.mtbf_chip_s)
                            if math.isfinite(grid.failure.mtbf_chip_s)
                            else None),
            "restart_s": float(grid.failure.restart_s),
            "reshard_s": float(grid.failure.reshard_s),
        }} if grid.goodput is not None and grid.failure is not None else {}),
        "points": [explain_point(grid, c, b)
                   for c in grid.chips_list for b in grid.batch_list],
    }


def _ms(s: float) -> str:
    return f"{s * 1e3:8.3f}"


def format_explain_table(records: Sequence[Dict]) -> str:
    """Per-candidate attribution as a table section (one grid point).

    The ep dispatch columns appear only when some candidate actually
    carries an ep axis, keeping the three-axis table unchanged."""
    eped = any(r.get("ep", 1) > 1 for r in records)
    head = (f"{'rank':>4} {'mesh':>12} {'mb':>4} {'z':>2} "
            f"{'comp ms':>8} {'mem ms':>8} "
            f"{'dpα ms':>8} {'dpB ms':>8} {'tpα ms':>8} {'tpB ms':>8} "
            f"{'ppα ms':>8} {'ppB ms':>8} "
            + (f"{'epα ms':>8} {'epB ms':>8} " if eped else "")
            + f"{'bubble':>7} "
            f"{'step ms':>8} {'bound':>7}")
    lines = [head, "-" * len(head)]
    for r, rec in enumerate(records):
        t = rec["terms"]
        net = t["network"]
        ep_cols = (
            f"{_ms(net['ep']['alpha_steps'])} "
            f"{_ms(net['ep']['bytes_over_bw'])} " if eped else "")
        lines.append(
            f"{r + 1:>4} {rec['mesh']:>12} {rec['microbatches']:>4} "
            f"{rec['zero_stage']:>2} "
            f"{_ms(rec['t_compute'])} {_ms(rec['t_memory'])} "
            f"{_ms(net['dp']['alpha_steps'])} {_ms(net['dp']['bytes_over_bw'])} "
            f"{_ms(net['tp']['alpha_steps'])} {_ms(net['tp']['bytes_over_bw'])} "
            f"{_ms(net['pp']['alpha_steps'])} {_ms(net['pp']['bytes_over_bw'])} "
            + ep_cols
            + f"{100 * rec['pipeline_bubble']['fraction']:6.1f}% "
            f"{_ms(rec['runtime'])} {rec['bottleneck']:>7}")
    return "\n".join(lines)


def format_prune_reasons(point: Dict) -> str:
    """One-line prune account for a grid point's explain record."""
    r = point["prune_reasons"]
    parts = [f"{k}={v}" for k, v in sorted(r.items()) if v]
    line = (f"# pruned @ chips={point['chips']} batch={point['batch']}: "
            + (", ".join(parts) if parts else "nothing"))
    if point["min_zero_to_fit"]:
        line += f" (infeasible without ZeRO-{point['min_zero_to_fit']})"
    return line


def to_json(grid: "PlanGrid", indent: int = 1) -> str:
    return json.dumps(explain_dict(grid), indent=indent, sort_keys=True)
