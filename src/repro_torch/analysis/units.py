"""A small unit algebra for the cost model's physical quantities.

The Ridgeline is dimensional analysis: ``t_C = α_C + F/(PEAK·eff(F))`` only
bounds anything if FLOPs, bytes, seconds, and their rates never get
conflated.  This module is the algebra the units lint (``repro_torch.analysis
.lint``) propagates through the AST: a :class:`Unit` is a vector of integer
exponents over the three base dimensions

    flop    floating-point operations (work)
    byte    bytes (memory or wire traffic — same dimension)
    s       seconds (wall time)

so ``bytes/s`` is ``byte·s⁻¹``, dividing ``bytes`` by ``bytes/s`` yields
``seconds``, and adding ``flops`` to ``bytes`` is a dimension error.  The
six canonical units of the cost model (``flops``, ``bytes``, ``seconds``,
``bytes/s``, ``flops/s``, ``dimensionless``) have names; everything else
prints as an exponent product (e.g. the ridge point ``flops/byte``).

Pure stdlib, no numpy: the linter must run anywhere CI does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["Unit", "UnitError", "parse_unit", "FLOPS", "BYTES", "SECONDS",
           "BYTES_PER_S", "FLOPS_PER_S", "DIMENSIONLESS", "NAMED_UNITS"]


class UnitError(ValueError):
    """A dimensional inconsistency (raised by the algebra, not the linter)."""


@dataclasses.dataclass(frozen=True)
class Unit:
    """A product of integer powers of the base dimensions.

    ``dims`` is a sorted tuple of (dimension, exponent) pairs with zero
    exponents dropped, so equal units compare (and hash) equal — the
    dimensionless unit is the empty tuple.
    """

    dims: Tuple[Tuple[str, int], ...] = ()

    @staticmethod
    def of(**exponents: int) -> "Unit":
        return Unit(tuple(sorted((d, e) for d, e in exponents.items()
                                 if e != 0)))

    @property
    def is_dimensionless(self) -> bool:
        return not self.dims

    def _as_dict(self) -> Dict[str, int]:
        return dict(self.dims)

    def __mul__(self, other: "Unit") -> "Unit":
        d = self._as_dict()
        for dim, e in other.dims:
            d[dim] = d.get(dim, 0) + e
        return Unit.of(**d)

    def __truediv__(self, other: "Unit") -> "Unit":
        d = self._as_dict()
        for dim, e in other.dims:
            d[dim] = d.get(dim, 0) - e
        return Unit.of(**d)

    def __pow__(self, k: int) -> "Unit":
        if not isinstance(k, int):
            raise UnitError(f"unit exponent must be an int, got {k!r}")
        return Unit.of(**{dim: e * k for dim, e in self.dims})

    def commensurable(self, other: "Unit") -> bool:
        """Can the two be added/subtracted/compared? (Same dimensions.)"""
        return self.dims == other.dims

    def __str__(self) -> str:
        name = _UNIT_NAMES.get(self.dims)
        if name is not None:
            return name
        num = [dim if e == 1 else f"{dim}^{e}"
               for dim, e in self.dims if e > 0]
        den = [dim if e == -1 else f"{dim}^{-e}"
               for dim, e in self.dims if e < 0]
        if not num:
            num = ["1"]
        return "*".join(num) + ("/" + "/".join(den) if den else "")


FLOPS = Unit.of(flop=1)
BYTES = Unit.of(byte=1)
SECONDS = Unit.of(s=1)
BYTES_PER_S = BYTES / SECONDS
FLOPS_PER_S = FLOPS / SECONDS
DIMENSIONLESS = Unit()

#: the canonical cost-model vocabulary, as spelled in declarations
NAMED_UNITS: Dict[str, Unit] = {
    "flops": FLOPS,
    "bytes": BYTES,
    "seconds": SECONDS,
    "s": SECONDS,
    "bytes/s": BYTES_PER_S,
    "flops/s": FLOPS_PER_S,
    "dimensionless": DIMENSIONLESS,
    "1": DIMENSIONLESS,
}

_UNIT_NAMES: Dict[Tuple[Tuple[str, int], ...], str] = {
    FLOPS.dims: "flops", BYTES.dims: "bytes", SECONDS.dims: "seconds",
    BYTES_PER_S.dims: "bytes/s", FLOPS_PER_S.dims: "flops/s",
    DIMENSIONLESS.dims: "dimensionless",
}


def parse_unit(spec: str) -> Unit:
    """A unit from its declaration spelling: named, or ``a/b`` quotients.

    Accepts any :data:`NAMED_UNITS` name and quotients/products of them
    (``"bytes/s"``, ``"flops/byte"``); unknown tokens raise ``UnitError``
    naming the vocabulary.
    """
    spec = spec.strip()
    if spec in NAMED_UNITS:
        return NAMED_UNITS[spec]
    # token/token[/token...] — each token a named unit or base dimension
    base = {"flop": FLOPS, "byte": BYTES}
    parts = spec.split("/")
    out: Optional[Unit] = None
    for i, raw in enumerate(parts):
        tok = raw.strip()
        u = NAMED_UNITS.get(tok, base.get(tok))
        if u is None:
            raise UnitError(
                f"unknown unit {tok!r} in {spec!r}; vocabulary: "
                f"{sorted(NAMED_UNITS)} plus base dims {sorted(base)}")
        out = u if out is None else (out / u if i else out * u)
    if out is None:
        raise UnitError(f"empty unit spec {spec!r}")
    return out


def unify(a: Optional[Unit], b: Optional[Unit]) -> Optional[Unit]:
    """Branch-join for the linter: None (unknown) absorbs, mismatch raises.

    Used for ``np.where``/ternary branches and min/max arguments — the two
    sides must be commensurable for the result to mean anything.
    """
    if a is None or b is None:
        return None
    if not a.commensurable(b):
        raise UnitError(f"incommensurable units {a} and {b}")
    return a


def check_commensurable(a: Mapping, b: Mapping) -> bool:  # pragma: no cover
    raise NotImplementedError  # placeholder guard: use Unit.commensurable
