"""Prefill: a closed loop of one batch in flight, each forward a new batch
of prompts drawn from the seed, through the port's
``transformer.forward(params, tokens, cfg)``.

The traffic file gives ``batch`` and ``seq`` (and ``trace_units``, the
forwards a traced run profiles).  The logits of two of the window's
forwards, drawn from the seed (``KEPT``), are kept for the check; each is
compared, row by row, with the plain reference over the same prompts.

The model is an MoE, whose routing is discrete: a router logit that bf16
rounding moves past its neighbour sends the token to another expert, and
over 24 layers such flips make the logits of bf16 and float32 forwards
diverge wholly (PERF.md).  So the reference follows the program's expert choices, and
the choices are judged by themselves: ``routing_gap_max``, the widest a
chosen expert's router logit falls below the reference's k-th largest.  The
program exposes no choices, so ``RouteTap`` takes them from
``repro_torch.models.moe.route`` in the two kept forwards alone; the other
forwards of the window run the program untouched.  Where a kept forward's
MoE layers gave no choices (the program routes by another function), the
check cannot follow them and fails, saying so.
"""
from __future__ import annotations

import contextlib
import random
import statistics
import sys
from typing import Dict, List

import torch

from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer

from ridgebench import weights
from ridgebench.model import model_config
from ridgebench.reference import compare
from ridgebench.reference import lm as ref_lm
from ridgebench.work import lm as work_lm

WARM_UNITS = 2
#: the kept forwards: one drawn among the window's units [0, 4), one
#: among [4, 32)
KEPT = ((0, 4), (4, 32))
#: what a number reads where the check could not compare (past any limit,
#: and finite, so that the result line stays JSON)
NOT_COMPARED = 1e30


class RouteTap:
    """Stands in for ``moe.route`` during one forward and keeps each call's
    expert choices, the second of what it returns (no copy, no sync)."""

    def __init__(self):
        self.real = moe_mod.route
        self.calls: list = []

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.calls.append(out[1])
        return out

    def __enter__(self):
        self.calls = []
        moe_mod.route = self
        return self

    def __exit__(self, *exc):
        moe_mod.route = self.real


class Cell:
    def __init__(self, doc: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.doc, self.device = doc, device
        self.B, self.S = traffic["batch"], traffic["seq"]
        self.cfg = model_config(doc)
        self.params = weights.draw(doc, seed, device)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) + 1)
        rng = random.Random(int(seed))
        #: the window's units whose outputs the check compares
        self.kept_at = sorted(rng.randrange(a, b) for a, b in KEPT)
        self.kept: List[tuple] = []
        for _ in range(WARM_UNITS):
            self._forward(tap=False)

    def _forward(self, tap: bool):
        tokens = torch.randint(0, self.doc["vocab_size"], (self.B, self.S),
                               generator=self.gen, device=self.device)
        with RouteTap() if tap else contextlib.nullcontext() as t, \
                torch.no_grad():
            logits, _ = transformer.forward(self.params, tokens, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tokens, logits, t.calls if tap else None

    def unit(self, i: int) -> None:
        kept = i in self.kept_at
        out = self._forward(tap=kept)
        if kept:
            self.kept.append(out)

    def end_to_end(self, seconds: List[float], window_s: float) -> Dict:
        ms = [1e3 * s for s in seconds]
        return {"prefill_tokens_per_s": (self.B * self.S * len(seconds)
                                         / window_s, "tokens/s"),
                "prefill_ms_p90": (statistics.quantiles(
                    ms, n=10, method="inclusive")[8], "ms")}

    def work(self) -> Dict:
        return {"kind": "prefill", "batch": self.B, "seq": self.S,
                "flops": work_lm.forward_flops(self.doc, self.B, self.S)}

    def check(self, control: bool = False, extra: bool = False
              ) -> Dict[str, float]:
        """The row statistics of the kept logits against the float32
        reference over the same prompts, on the same expert choices, and
        ``routing_gap_max``.  ``control``: the reference in
        fp8, routing by itself, takes the program's place.  ``extra``:
        ``spread_stats`` too."""
        outs, self.kept = self.kept, []
        if not outs:
            raise RuntimeError("no forward of the window was kept: it ran "
                               f"fewer than {self.kept_at[0] + 1} units")
        layers = self.doc["num_hidden_layers"]
        if any(len(c) != layers for _, _, c in outs):
            print("ridgebench: moe.route gave no expert choices in a kept "
                  "forward; the reference cannot follow the program's "
                  "routing", file=sys.stderr)
            return dict.fromkeys(("logits_err_p50", "logits_err_max",
                                  "routing_gap_max"), NOT_COMPARED)
        errs, gaps, gap = [], [], 0.0
        with ref_lm.exact_fp32():
            for tokens, lg, choices in outs:
                if control:
                    low = ref_lm.Routing()
                    gots = ref_lm.row_blocks(self.params, tokens, self.doc,
                                             ref_lm.Arith("fp8"), low)
                    choices = low.chosen
                else:
                    gots = iter(lg)
                routing = ref_lm.Routing(follow=choices)
                refs = ref_lm.row_blocks(self.params, tokens, self.doc,
                                         ref_lm.Arith("fp32"), routing)
                for got, ref in zip(gots, refs, strict=True):
                    errs.append(compare.row_errors(got, ref))
                    if extra:
                        gaps.append(compare.greedy_gaps(got, ref))
                gap = max(gap, routing.gap)
        out = dict(compare.row_stats(errs), routing_gap_max=gap)
        if extra:
            out.update(compare.spread_stats(errs, gaps))
        return out


def fault_altered_row(logits: torch.Tensor) -> torch.Tensor:
    """One answer altered where it is produced: the first prompt's last
    position, whose logits give the token its prefill serves, takes the
    logits of the position before it."""
    out = logits.clone()
    out[0, -1] = logits[0, -2]
    return out


def fault_half_batch(logits: torch.Tensor) -> torch.Tensor:
    """Half of the batch left out: its logits are zeros."""
    out = logits.clone()
    out[logits.shape[0] // 2:] = 0
    return out


#: the faults the tests plant in the forward's output
FAULTS = {"altered_row": fault_altered_row, "half_batch": fault_half_batch}
