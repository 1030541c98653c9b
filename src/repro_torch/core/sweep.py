"""Vectorized Ridgeline sweeps: whole scenario grids in one NumPy pass.

A copy of ``repro.core.sweep`` (host arithmetic; it never touches the
card).  The scalar model (``core/ridgeline``) places one WorkUnit at a
time; the paper's case study and the parallelism planner both need
*surfaces* — bottleneck maps and projected-runtime grids over
(batch × mesh × strategy × hardware × collective algorithm).  This module
evaluates those grids with broadcast arithmetic instead of Python loops:
every input of :func:`sweep` broadcasts against every other, so a
``(n_batch, 1)`` flops column against a ``(1, n_mesh)`` net-bytes row yields
the full 2-D map directly.

Classification is the argmax of the three resource times with the same
COMPUTE > MEMORY > NETWORK tie-break as the scalar path.  ``eff_grid`` and
``sweep`` carry the reference's ``@shape_contract`` declarations
(``repro_torch.analysis.contracts``), checked at run time when
``REPRO_CHECK`` is set.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analysis.contracts import shape_contract
from repro_torch.core.hardware import (EfficiencyModel, HardwareSpec,
                                       get_hardware)
from repro_torch.core.ridgeline import Resource
from repro_torch.obs import trace

ArrayLike = Union[float, np.ndarray]
HardwareLike = Union[HardwareSpec, str]

#: code order == argmax priority order (ties resolve to the earlier entry),
#: matching the scalar classifier's COMPUTE > MEMORY > NETWORK convention
RESOURCE_ORDER: Tuple[Resource, ...] = (
    Resource.COMPUTE, Resource.MEMORY, Resource.NETWORK)
RESOURCE_CODES: Dict[Resource, int] = {r: i for i, r in
                                       enumerate(RESOURCE_ORDER)}
_LABELS = np.array([r.value for r in RESOURCE_ORDER])


def _safe_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized twin of ridgeline._safe_div: x/0 -> inf (x>0) else 0."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    a, b = np.broadcast_arrays(a, b)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(b != 0, a / np.where(b != 0, b, 1.0),
                       np.where(a > 0, np.inf, 0.0))
    return out


@shape_contract("q:(*g) -> (*g)")
def eff_grid(model: Optional[EfficiencyModel], q: ArrayLike):
    """Vectorized twin of ``EfficiencyModel.eff`` (property-tested against
    the scalar): achievable-fraction-of-peak on a grid of work sizes.

    Returns the scalar 1.0 for the identity model so the caller's
    ``peak * eff`` stays bit-exact with the constant-ceiling model.
    """
    if model is None or model.is_identity:
        return 1.0
    q = np.asarray(q, dtype=np.float64)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        ratio = np.where(q > 0,
                         (model.f_half / np.where(q > 0, q, 1.0)) ** model.p,
                         np.inf)            # q <= 0 -> the eff_min floor
    return model.eff_min + (1.0 - model.eff_min) / (1.0 + ratio)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Every Ridgeline quantity, on the full broadcast grid."""

    flops: np.ndarray
    mem_bytes: np.ndarray
    net_bytes: np.ndarray
    t_compute: np.ndarray
    t_memory: np.ndarray
    t_network: np.ndarray
    runtime: np.ndarray              # max of the three times (projected bound)
    bottleneck: np.ndarray           # int8 codes into RESOURCE_ORDER
    attained_flops: np.ndarray
    peak_fraction: np.ndarray
    x: np.ndarray                    # I_M = B_M / B_N
    y: np.ndarray                    # I_A = F / B_M

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.runtime.shape

    def labels(self) -> np.ndarray:
        """Bottleneck names ('compute'|'memory'|'network') on the grid."""
        return _LABELS[self.bottleneck]

    def resources(self) -> np.ndarray:
        """Bottlenecks as Resource enums (object array on the grid)."""
        return np.array(RESOURCE_ORDER, dtype=object)[self.bottleneck]

    def region_counts(self) -> Dict[str, int]:
        lab, cnt = np.unique(self.bottleneck, return_counts=True)
        return {RESOURCE_ORDER[int(l)].value: int(c)
                for l, c in zip(lab, cnt)}


@shape_contract(
    "flops:(*g), mem_bytes:(*g), net_bytes:(*g), net_steps:(*g), "
    "peak_flops:(*g), hbm_bw:(*g), net_bw:(*g), alpha_compute:(*g), "
    "alpha_memory:(*g), alpha_network:(*g) -> (*g)")
def sweep(flops: ArrayLike, mem_bytes: ArrayLike, net_bytes: ArrayLike,
          hw: Optional[HardwareLike] = None, *,
          peak_flops: Optional[ArrayLike] = None,
          hbm_bw: Optional[ArrayLike] = None,
          net_bw: Optional[ArrayLike] = None,
          net_steps: ArrayLike = 0.0,
          alpha_compute: Optional[ArrayLike] = None,
          alpha_memory: Optional[ArrayLike] = None,
          alpha_network: Optional[ArrayLike] = None,
          compute_eff: Optional[EfficiencyModel] = None) -> SweepResult:
    """Evaluate the (α-aware) Ridgeline on a broadcast grid of work units.

    Machine peaks come either from ``hw`` (one spec for the whole grid; a
    string resolves through the port's ``core.hardware.get_hardware``, so
    calibrated registry names work anywhere a spec does) or from explicit
    ``peak_flops``/``hbm_bw``/``net_bw`` arrays, which also broadcast —
    sweeping *hardware* is just another grid axis.  α terms and ``net_steps``
    (serialized network hops) broadcast the same way and default from ``hw``
    (0 without one), reproducing the bandwidth-only model when all zero:

        t_C = α_C·[F>0] + F/(peak·eff(F))   t_M = α_M·[B_M>0] + B_M/hbm
        t_N = α_N·steps + B_N/net

    ``compute_eff`` (defaulting from ``hw``, identity without one) is the
    size-dependent achievable-PEAK curve: the effective compute ceiling of
    each grid cell is ``peak · eff(F)``.  The identity curve keeps the
    constant-ceiling times bit-for-bit.

    Runs under a ``core.sweep`` trace span carrying the evaluated cell
    count (``repro_torch.obs.trace``; a no-op unless tracing is enabled).
    """
    with trace.span("core.sweep") as sp:
        res = _sweep_impl(
            flops, mem_bytes, net_bytes, hw, peak_flops=peak_flops,
            hbm_bw=hbm_bw, net_bw=net_bw, net_steps=net_steps,
            alpha_compute=alpha_compute, alpha_memory=alpha_memory,
            alpha_network=alpha_network, compute_eff=compute_eff)
        sp.set(cells=int(res.runtime.size))
        return res


def _sweep_impl(flops: ArrayLike, mem_bytes: ArrayLike, net_bytes: ArrayLike,
                hw: Optional[HardwareLike] = None, *,
                peak_flops: Optional[ArrayLike] = None,
                hbm_bw: Optional[ArrayLike] = None,
                net_bw: Optional[ArrayLike] = None,
                net_steps: ArrayLike = 0.0,
                alpha_compute: Optional[ArrayLike] = None,
                alpha_memory: Optional[ArrayLike] = None,
                alpha_network: Optional[ArrayLike] = None,
                compute_eff: Optional[EfficiencyModel] = None) -> SweepResult:
    if isinstance(hw, str):
        hw = get_hardware(hw)
    if hw is not None:
        peak_flops = hw.peak_flops if peak_flops is None else peak_flops
        hbm_bw = hw.hbm_bw if hbm_bw is None else hbm_bw
        net_bw = hw.net_bw if net_bw is None else net_bw
        alpha_compute = hw.alpha_compute if alpha_compute is None \
            else alpha_compute
        alpha_memory = hw.alpha_memory if alpha_memory is None \
            else alpha_memory
        alpha_network = hw.alpha_network if alpha_network is None \
            else alpha_network
        compute_eff = hw.compute_eff if compute_eff is None else compute_eff
    if peak_flops is None or hbm_bw is None or net_bw is None:
        raise ValueError("pass hw= or all three of peak_flops/hbm_bw/net_bw")
    alpha_compute = 0.0 if alpha_compute is None else alpha_compute
    alpha_memory = 0.0 if alpha_memory is None else alpha_memory
    alpha_network = 0.0 if alpha_network is None else alpha_network

    f, bm, bn, pk, mb, nb, ns, a_c, a_m, a_n = np.broadcast_arrays(
        *(np.asarray(v, dtype=np.float64)
          for v in (flops, mem_bytes, net_bytes, peak_flops, hbm_bw, net_bw,
                    net_steps, alpha_compute, alpha_memory, alpha_network)))
    t_c = np.where(f > 0, a_c, 0.0) + _safe_div(f, pk * eff_grid(
        compute_eff, f))
    t_m = np.where(bm > 0, a_m, 0.0) + _safe_div(bm, mb)
    t_n = a_n * ns + _safe_div(bn, nb)
    times = np.stack([t_c, t_m, t_n])       # axis 0 == RESOURCE_ORDER
    runtime = times.max(axis=0)
    # np.argmax returns the first maximal index -> the priority tie-break
    bottleneck = times.argmax(axis=0).astype(np.int8)
    attained = np.where(runtime > 0, _safe_div(f, runtime), 0.0)
    return SweepResult(
        flops=f, mem_bytes=bm, net_bytes=bn,
        t_compute=t_c, t_memory=t_m, t_network=t_n,
        runtime=runtime, bottleneck=bottleneck,
        attained_flops=attained, peak_fraction=_safe_div(attained, pk),
        x=_safe_div(bm, bn), y=_safe_div(f, bm))


def grid(**axes: Sequence) -> Dict[str, np.ndarray]:
    """Named meshgrid: 1-D axes -> broadcastable N-D coordinate arrays.

    ``grid(batch=[...], dp=[...])`` returns arrays of shape
    ``(len(batch), len(dp))`` in the keyword order given.
    """
    names = list(axes)
    arrays = np.meshgrid(*(np.asarray(axes[n]) for n in names),
                         indexing="ij")
    return dict(zip(names, arrays))


# --- ridge crossings ----------------------------------------------------------


def crossover(xs: ArrayLike, t_a: ArrayLike, t_b: ArrayLike,
              log_x: bool = False) -> Optional[float]:
    """The x where the curves ``t_a`` and ``t_b`` cross (first sign change).

    Linearly interpolates ``t_a − t_b`` between the bracketing samples
    (in log-x when ``log_x``); exact when the difference is linear in x —
    e.g. constant network time vs batch-linear compute time (Fig. 4c).
    Returns None when the curves never cross on the sampled range.

    With ``log_x`` a bracket touching a nonpositive sample (where log is
    undefined) falls back to linear interpolation for that bracket instead
    of raising — sampled grids that start at 0 are common in sweeps.
    """
    xs = np.asarray(xs, dtype=np.float64)
    d = np.asarray(t_a, dtype=np.float64) - np.asarray(t_b, dtype=np.float64)
    sign = np.sign(d)
    idx = np.nonzero(sign[:-1] * sign[1:] < 0)[0]
    if idx.size == 0:
        exact = np.nonzero(sign == 0)[0]
        return float(xs[exact[0]]) if exact.size else None
    i = int(idx[0])
    use_log = log_x and xs[i] > 0 and xs[i + 1] > 0
    x0, x1 = (math.log(xs[i]), math.log(xs[i + 1])) if use_log else \
        (xs[i], xs[i + 1])
    frac = d[i] / (d[i] - d[i + 1])
    xc = x0 + frac * (x1 - x0)
    return float(math.exp(xc)) if use_log else float(xc)


def transitions(result: SweepResult, xs: Optional[ArrayLike] = None
                ) -> List[Tuple[int, str, str]]:
    """Bottleneck changes along a 1-D sweep: (index-after, from, to).

    ``xs`` is unused for the indices but validates the sweep is 1-D and
    aligned when provided.
    """
    labels = result.labels()
    if labels.ndim != 1:
        raise ValueError(f"transitions needs a 1-D sweep, got {labels.shape}")
    if xs is not None and len(np.asarray(xs)) != labels.shape[0]:
        raise ValueError("xs length does not match sweep length")
    return [(i + 1, str(labels[i]), str(labels[i + 1]))
            for i in range(labels.shape[0] - 1)
            if labels[i] != labels[i + 1]]


def ridge_crossing(result: SweepResult, xs: ArrayLike,
                   a: Resource = Resource.NETWORK,
                   b: Resource = Resource.COMPUTE,
                   log_x: bool = True) -> Optional[float]:
    """Interpolated x where resource ``a``'s time hands over to ``b``'s."""
    times = {Resource.COMPUTE: result.t_compute,
             Resource.MEMORY: result.t_memory,
             Resource.NETWORK: result.t_network}
    return crossover(xs, times[a], times[b], log_x=log_x)
