"""The numbers that decide ``correct``: what the port produced against the
plain reference, as plain float32 arithmetic on both sides' outputs.

Logits (prefill): each row (one position's logits over the vocabulary) is
judged by its relative distance ``|got - ref| / |ref|`` (L2 norms over the
row); a run gives the median and the largest over every row it compares.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch


def row_errors(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Relative L2 distance of each row of ``got`` (any dtype) from the
    float32 ``ref``; both (rows, V)."""
    g = got.float()
    return (g - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)


def greedy_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's gap by which the reference's logit of the program's
    first-ranked token lies below the reference's best, in units of the
    reference row's standard deviation."""
    pick = got.float().argmax(-1, keepdim=True)
    return (ref.max(-1).values - ref.gather(-1, pick)[:, 0]) \
        / ref.std(-1).clamp_min(1e-30)


def row_stats(errors: Sequence[torch.Tensor]) -> Dict[str, float]:
    """``logits_err_p50`` and ``logits_err_max`` over every row compared,
    each of ``errors`` one sequence's row errors."""
    e = torch.cat([x.flatten().float().cpu() for x in errors])
    return {"logits_err_p50": float(e.median()),
            "logits_err_max": float(e.max())}


def spread_stats(errors: Sequence[torch.Tensor],
                 gaps: Sequence[torch.Tensor]) -> Dict[str, float]:
    """Further statistics of the same rows, for the readings that set the
    limits: quantiles of the row errors, the widest greedy gap over every
    row, and the share of rows whose first-ranked token differs."""
    e = torch.cat([x.flatten().float().cpu() for x in errors])
    g = torch.cat([x.flatten().float().cpu() for x in gaps])
    q = torch.quantile(e, torch.tensor([0.1, 0.25, 0.9, 0.99]))
    return {"err_p10": float(q[0]), "err_p25": float(q[1]),
            "err_p90": float(q[2]), "err_p99": float(q[3]),
            "gap_max": float(g.max()),
            "argmax_differs": float((g > 0).float().mean())}
