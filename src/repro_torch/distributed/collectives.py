"""Per-chip all-reduce cost (α–β accounting), copied from
``repro.distributed.collectives``.

``payload_bytes`` is the full reduced tensor; ``group_size`` ``n`` may be a
float (``math.inf`` gives the paper's large-n asymptote, 2·payload on a
ring), and ``n == 1`` costs nothing.  Wire bytes are what each chip sends on
its busiest link:

  ring    2·(n−1)/n · payload, 2·(n−1) hops  (reduce-scatter + all-gather)
  bidir   (n−1)/n · payload, n−1 hops        (two half-payload rings)
  tree    2·payload (n>1), 2·⌈log2 n⌉ hops   (send up + forward down)

With a per-hop latency α, ``CollectiveCost.time`` is
``α·steps + wire_bytes/link_bw``.  The functions broadcast over numpy
arrays, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np

ArrayLike = Union[float, np.ndarray]

#: supported all-reduce algorithm tags
ALGORITHMS = ("ring", "bidir_ring", "tree")

#: CLI-friendly short names accepted anywhere an algorithm tag is
ALGORITHM_ALIASES = {"bidir": "bidir_ring"}


def canonical_algorithm(name: str) -> str:
    """Resolve an algorithm tag or alias; unknown names raise with options."""
    name = ALGORITHM_ALIASES.get(name, name)
    if name not in ALGORITHMS:
        raise ValueError(f"unknown all-reduce algorithm {name!r}; "
                         f"have {ALGORITHMS} (aliases "
                         f"{sorted(ALGORITHM_ALIASES)})")
    return name


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """Per-chip cost of one collective: bytes on the busiest link + hops."""

    wire_bytes: ArrayLike
    steps: ArrayLike

    def time(self, link_bw: float, alpha: float = 0.0) -> ArrayLike:
        """α–β time: ``alpha·steps + wire_bytes/link_bw``."""
        return (np.asarray(alpha, dtype=np.float64) * np.asarray(self.steps)
                + np.asarray(self.wire_bytes) / link_bw)

    def __add__(self, other: "CollectiveCost") -> "CollectiveCost":
        """Serial composition: bytes and hops both accumulate."""
        return CollectiveCost(
            np.asarray(self.wire_bytes) + np.asarray(other.wire_bytes),
            np.asarray(self.steps) + np.asarray(other.steps))

    def scaled(self, k: ArrayLike) -> "CollectiveCost":
        """``k`` back-to-back executions of this collective."""
        k = np.asarray(k, dtype=np.float64)
        return CollectiveCost(k * np.asarray(self.wire_bytes),
                              k * np.asarray(self.steps))


def _ring_factor(n: ArrayLike) -> np.ndarray:
    """(n−1)/n with n=1 → 0 and n=inf → 1, elementwise."""
    n = np.asarray(n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        f = 1.0 - 1.0 / n
    return np.where(n <= 1.0, 0.0, f)


def _active(n: ArrayLike) -> np.ndarray:
    """1.0 where the group actually communicates (n > 1), else 0.0."""
    return np.where(np.asarray(n, dtype=np.float64) > 1.0, 1.0, 0.0)


def _log2_steps(n: ArrayLike) -> np.ndarray:
    n = np.asarray(n, dtype=np.float64)
    with np.errstate(divide="ignore", over="ignore"):
        return np.where(n > 1.0, np.ceil(np.log2(np.where(n > 1.0, n, 2.0))),
                        0.0)


def all_reduce(payload_bytes: ArrayLike, group_size: ArrayLike,
               algorithm: str = "ring") -> CollectiveCost:
    p = np.asarray(payload_bytes, dtype=np.float64)
    n = np.asarray(group_size, dtype=np.float64)
    if algorithm == "ring":
        return CollectiveCost(2.0 * _ring_factor(n) * p,
                              2.0 * np.maximum(n - 1.0, 0.0))
    if algorithm == "bidir_ring":
        return CollectiveCost(_ring_factor(n) * p, np.maximum(n - 1.0, 0.0))
    if algorithm == "tree":
        return CollectiveCost(2.0 * _active(n) * p, 2.0 * _log2_steps(n))
    raise ValueError(f"unknown all-reduce algorithm {algorithm!r}; "
                     f"have {ALGORITHMS}")
