"""Fit achievable α–β ceilings from measured (WorkUnit, seconds).

A copy of ``repro.measure.calibrate``'s fit and CLI over the port's
measurements.  The datasheet presets in ``core/hardware`` make every
Ridgeline projection a lower bound; this module replaces the vendor peaks
with what the card achieves, latency included:

  1. fit measurements are grouped by the resource their bench saturates by
     construction (``Measurement.category``: compute / memory / network);
  2. per resource, a 2-parameter least squares ``t ≈ α·u + q/peak``
     (``u = 1`` per execution for compute and memory, ``u = steps`` for the
     network), α clamped to ≥ 0; degenerate systems fall back to the
     bandwidth-only closed form;
  3. network points are grouped further by the ``link`` they rode, each
     link fitted on its own;
  4. the compute group also tries the size-dependent ceiling
     ``t ≈ F/(peak·eff(F))`` (``EfficiencyModel``); whichever model prices
     the compute points with less squared error wins.

A resource with no measurements keeps its datasheet value and is reported
``datasheet``: NET on one card, where there is no wire to time.  Whole-step
points only validate.  The result is one JSON file per spec in the port's
registry (``core/hardware.calibration_dir``; schema
``repro.calibration/v3``, the JAX package's keys).

CLI (the card; ``--device cpu`` runs the plain versions on the CPU)::

    python -m repro_torch.measure.calibrate --hardware h100_sxm_fp32 --smoke
    python -m repro_torch.measure.calibrate --smoke --device cpu --out DIR

Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank measures, the
all-reduces included, and rank 0 fits and writes.  As the reference's, the
CLI then writes one measured ``CellReport`` per validation step under
``<registry dir>/cells/`` and, when ``--figures`` is given or ``--out`` is
not, the calibrated plane's figures ``calibration_<name>.svg`` and
``.txt`` (``measure/overlay``; default directory ``figures_torch/`` beside
the registry: ``artifacts/figures_torch/``).  The suite and the fit run
under the reference's trace spans (``obs/trace``; ``REPRO_TORCH_TRACE``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.hardware import (CALIBRATED_SUFFIX, CALIBRATION_SCHEMA,
                                       PRESETS, EfficiencyModel, HardwareSpec,
                                       calibration_dir, get_hardware)
from repro_torch.core.ridgeline import resource_times
from repro_torch.measure.microbench import Measurement
from repro_torch.obs import trace
from repro_torch.obs.metrics import provenance


_RESOURCES = ("peak_flops", "hbm_bw", "net_bw")
_ALPHAS = ("alpha_compute", "alpha_memory", "alpha_network")

#: which wall-time statistic a calibration trusts per bench:
#: 'best' (fastest sample — robust to contention on shared boxes, the
#: classic bandwidth-benchmark convention) or 'median' (typical operating
#: point, right for dedicated nodes)
ESTIMATORS = ("best", "median")


def _quantities(m: Measurement) -> Tuple[float, float, float]:
    return (m.work.flops, m.work.mem_bytes, m.work.net_bytes)


def _observed(m: Measurement, estimator: str) -> float:
    return m.best if estimator == "best" else m.seconds


def _is_primary(link: Optional[str]) -> bool:
    return link in HardwareSpec.PRIMARY_LINKS


@dataclasses.dataclass
class _Params:
    """Mutable fit state: the α–β(+efficiency) parameters of one machine."""

    peaks: List[float]               # [peak_flops, hbm_bw, net_bw]
    alphas: List[float]              # [alpha_compute, alpha_memory, alpha_network]
    link_bws: Dict[str, float]       # extra (non-primary) link bandwidths
    link_alphas: Dict[str, float]    # per-hop α of those links
    compute_eff: EfficiencyModel = EfficiencyModel()

    @staticmethod
    def from_spec(hw: HardwareSpec) -> "_Params":
        return _Params(
            peaks=[hw.peak_flops, hw.hbm_bw, hw.net_bw],
            alphas=[hw.alpha_compute, hw.alpha_memory, hw.alpha_network],
            link_bws=dict(hw.extra_links),
            link_alphas={k: hw.link_alphas.get(k, hw.alpha_network)
                         for k in hw.extra_links},
            compute_eff=hw.compute_eff)

    def spec(self) -> HardwareSpec:
        """The current fit state as a HardwareSpec (for shared pricing).

        Cached after first use: pricing only happens once the parameters
        are final (the fit loop mutates fields but never prices mid-fit).
        """
        if getattr(self, "_spec_cache", None) is None:
            self._spec_cache = HardwareSpec(
                name="_fit", peak_flops=self.peaks[0], hbm_bw=self.peaks[1],
                net_bw=self.peaks[2], extra_links=dict(self.link_bws),
                alpha_compute=self.alphas[0], alpha_memory=self.alphas[1],
                alpha_network=self.alphas[2],
                link_alphas=dict(self.link_alphas),
                compute_eff=self.compute_eff)
        return self._spec_cache

    def times(self, m: Measurement) -> Tuple[float, float, float]:
        link = m.link
        if not _is_primary(link) and link not in self.link_bws:
            link = None    # link never seen (not even in the datasheet):
            #                price at the primary until a fit learns it
        return resource_times(m.work, self.spec(), link=link)


def _model_seconds(m: Measurement, params: _Params) -> float:
    return max(params.times(m))


def _assign(m: Measurement, params: _Params) -> int:
    times = params.times(m)
    return max(range(3), key=lambda r: (times[r], -r))


def _fit_alpha_beta(points: Sequence[Tuple[float, float, float]],
                    prior_peak: float) -> Tuple[float, float]:
    """Least-squares (α, peak) for ``t ≈ α·u + q/peak`` over (u, q, t).

    Physical constraints: α ≥ 0, peak > 0, and — since every observation
    satisfies ``t_i = α·u_i + q_i/peak ≥ α·u_i`` — the per-unit α cannot
    exceed ``min(t_i/u_i)``; a noisy intercept above that bound is clamped
    there and the peak refitted (noisy small boxes routinely produce such
    intercepts).  Degenerate systems (collinear regressors, a single point)
    drop the α column and reduce to the v1 bandwidth-only closed form
    ``1/peak = Σq·t / Σq²``.  ``prior_peak`` (the incoming ceiling) is kept
    whenever the data cannot determine the peak at all.
    """
    # absolute-error LS, deliberately: relative weighting would give the
    # latency-dominated small points decades more weight, and on noisy
    # shared boxes their jitter then whipsaws the fitted peak; absolute
    # weighting anchors the ceiling on the saturating sizes and lets the
    # intercept soak up what the small points agree on
    su2 = sq2 = suq = sut = sqt = 0.0
    for u, q, t in points:
        su2 += u * u
        sq2 += q * q
        suq += u * q
        sut += u * t
        sqt += q * t
    alpha_max = min((t / u for u, q, t in points if u > 0), default=0.0)
    times = [t for _, _, t in points if t > 0]
    # identifiability guard: separating an intercept from a slope needs
    # observed times spanning real dynamic range, otherwise measurement
    # noise lands almost entirely in α (two same-scale points fit *any*
    # intercept exactly); below the threshold fall back to β-only
    identifiable = bool(times) and max(times) >= 3.0 * min(times)

    def beta_only() -> Tuple[float, float]:
        if sq2 > 0 and sqt > 0:
            return 0.0, sq2 / sqt
        return 0.0, prior_peak

    def with_alpha(alpha: float) -> Tuple[float, float]:
        """Refit the peak with α held fixed (boundary of the constraint)."""
        resid = sqt - alpha * suq
        if sq2 > 0 and resid > 0:
            return alpha, sq2 / resid
        return alpha, prior_peak

    det = su2 * sq2 - suq * suq
    if not identifiable or det <= 1e-12 * max(su2 * sq2, 1e-300):
        return beta_only()
    alpha = (sut * sq2 - sqt * suq) / det
    c = (su2 * sqt - suq * sut) / det           # c = 1/peak
    if alpha < 0:
        return beta_only()
    if alpha > alpha_max:
        return with_alpha(alpha_max)
    if c <= 0:
        # all observed time is latency: α alone, peak stays at the prior
        resid = sut - suq / prior_peak if prior_peak > 0 else sut
        return min(max(resid / su2, 0.0), alpha_max), prior_peak
    return alpha, 1.0 / c


#: points at/above this achieved fraction count as saturated — they anchor
#: the peak but carry no shape information for the efficiency curve
_EFF_SATURATED = 0.97

#: fitted Hill exponents are confined to (0, 1]: below 0.1 is a noise
#: artifact, and p > 1 with a zero floor would price time *non-monotone*
#: in F (tinier work diverges) — p = 1 already equals the α–β intercept
#: model, so data steeper than that falls back to the intercept fit
_EFF_P_RANGE = (0.1, 1.0)


def _fit_efficiency(points: Sequence[Tuple[float, float, float]]
                    ) -> Optional[Tuple[float, EfficiencyModel]]:
    """Fit ``t ≈ q / (peak · eff(q))`` with the Hill efficiency curve.

    ``points`` are the same (u, q, t) triples the α–β fit sees; the
    efficiency model replaces the constant intercept with a size-dependent
    achievable ceiling (eff_min pinned at 0 — two shape parameters are all
    four-ish GEMM sizes can support):

      1. the achievable peak is the best observed rate ``max(q/t)``
         (time-based-roofline convention), refined below;
      2. per-point efficiencies ``e_i = (q_i/t_i)/peak`` are log-odds
         linearized — ``ln(1/e − 1) = p·ln f_half − p·ln q`` is a straight
         line in ln q — and (p, f_half) solved by least squares over the
         sub-saturated points;
      3. the peak is re-fitted by least squares with the shape held fixed
         (``t ≈ g(q)/peak, g = q/eff(q)``), which un-biases it from step 1's
         max-of-noisy-rates estimate.

    Returns None when the data cannot support the curve: fewer than three
    usable points, fewer than two meaningfully sub-saturated ones, or a
    fitted exponent outside the physical range (``p ≤ 0`` would be
    non-monotone).  The caller compares the result's squared error against
    the α–β fit and keeps the better model.
    """
    pos = [(q, t) for _, q, t in points if q > 0 and t > 0]
    if len(pos) < 3:
        return None
    peak = max(q / t for q, t in pos)
    for _ in range(2):                       # shape fit <-> peak refit
        reg = [(math.log(q), math.log(1.0 / e - 1.0))
               for q, t in pos
               for e in [(q / t) / peak]
               if e < _EFF_SATURATED]
        if len(reg) < 2:
            return None
        n = float(len(reg))
        sx = sum(x for x, _ in reg)
        sy = sum(y for _, y in reg)
        sxx = sum(x * x for x, _ in reg)
        sxy = sum(x * y for x, y in reg)
        det = n * sxx - sx * sx
        if det <= 0:
            return None
        p = -(n * sxy - sx * sy) / det       # slope is −p
        if not _EFF_P_RANGE[0] <= p <= _EFF_P_RANGE[1]:
            return None
        # intercept = p·ln f_half  ->  f_half
        f_half = math.exp((sy + p * sx) / (n * p))
        model = EfficiencyModel(f_half=f_half, p=p)
        # peak refit: t ≈ g(q)/peak with g = q/eff(q)
        sg2 = sum((q / model.eff(q)) ** 2 for q, _ in pos)
        sgt = sum((q / model.eff(q)) * t for q, t in pos)
        if sg2 <= 0 or sgt <= 0:
            return None
        peak = sg2 / sgt
    return peak, model


def _sse(points: Sequence[Tuple[float, float, float]],
         predict) -> float:
    return sum((predict(u, q) - t) ** 2 for u, q, t in points)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Fitted achievable α–β parameters + the evidence behind them."""

    name: str
    base: HardwareSpec
    peak_flops: float
    hbm_bw: float
    net_bw: float
    sources: Dict[str, str]          # resource/link -> 'measured' | 'datasheet'
    iterations: int
    fit_measurements: Tuple[Measurement, ...]
    validation_measurements: Tuple[Measurement, ...] = ()
    estimator: str = "best"          # see ESTIMATORS
    alpha_compute: float = 0.0       # s per execution
    alpha_memory: float = 0.0        # s per execution
    alpha_network: float = 0.0       # s per serialized hop (primary link)
    link_bws: Dict[str, float] = dataclasses.field(default_factory=dict)
    link_alphas: Dict[str, float] = dataclasses.field(default_factory=dict)
    compute_eff: EfficiencyModel = EfficiencyModel()   # eff(F) ceiling curve

    @property
    def peaks(self) -> Tuple[float, float, float]:
        return (self.peak_flops, self.hbm_bw, self.net_bw)

    @property
    def alphas(self) -> Tuple[float, float, float]:
        return (self.alpha_compute, self.alpha_memory, self.alpha_network)

    @functools.cached_property
    def _pricing_params(self) -> _Params:
        return self._params()

    def _params(self) -> _Params:
        # unmeasured links keep their datasheet bandwidths here too, so
        # model_seconds/rel_error agree with what spec() would predict
        link_bws = dict(self.base.extra_links)
        link_bws.update(self.link_bws)
        return _Params(peaks=list(self.peaks), alphas=list(self.alphas),
                       link_bws=link_bws,
                       link_alphas=dict(self.link_alphas),
                       compute_eff=self.compute_eff)

    def spec(self) -> HardwareSpec:
        """The calibrated HardwareSpec.

        Extra links carry their *own* fitted (α, bandwidth) where measured;
        unmeasured links keep the datasheet number rather than being scaled
        by the primary-NET ratio (the v1 behaviour this fit replaces).
        """
        extra = dict(self.base.extra_links)
        extra.update(self.link_bws)
        summary = self.error_summary("validation")
        return HardwareSpec(
            name=self.name,
            peak_flops=self.peak_flops,
            hbm_bw=self.hbm_bw,
            net_bw=self.net_bw,
            extra_links=extra,
            alpha_compute=self.alpha_compute,
            alpha_memory=self.alpha_memory,
            alpha_network=self.alpha_network,
            link_alphas=dict(self.link_alphas),
            model_rel_error=summary["median_abs_rel_error"],
            compute_eff=self.compute_eff,
            vmem_bytes=self.base.vmem_bytes,
            hbm_capacity_bytes=self.base.hbm_capacity_bytes,
            ckpt_bw=self.base.ckpt_bw,
        )

    # ---- model-vs-measured error --------------------------------------------
    def model_seconds(self, m: Measurement) -> float:
        return _model_seconds(m, self._pricing_params)

    def observed_seconds(self, m: Measurement) -> float:
        return _observed(m, self.estimator)

    def rel_error(self, m: Measurement) -> float:
        """(model − measured) / measured: negative = model under-predicts."""
        obs = self.observed_seconds(m)
        return (self.model_seconds(m) - obs) / obs

    def errors(self, which: str = "all") -> Dict[str, float]:
        ms = {"fit": self.fit_measurements,
              "validation": self.validation_measurements,
              "all": self.fit_measurements + self.validation_measurements,
              }[which]
        return {m.work.name: self.rel_error(m) for m in ms}

    def error_summary(self, which: str = "all") -> Dict[str, float]:
        errs = sorted(abs(e) for e in self.errors(which).values())
        if not errs:
            return {"n": 0, "median_abs_rel_error": 0.0,
                    "max_abs_rel_error": 0.0}
        mid = len(errs) // 2
        median = errs[mid] if len(errs) % 2 else \
            0.5 * (errs[mid - 1] + errs[mid])
        return {"n": len(errs), "median_abs_rel_error": median,
                "max_abs_rel_error": errs[-1]}

    # ---- persistence ---------------------------------------------------------
    def to_dict(self) -> Dict:
        params = self._params()

        def dump(ms: Sequence[Measurement]) -> List[Dict]:
            out = []
            for m in ms:
                d = m.to_dict()
                d["assigned"] = _RESOURCES[_assign(m, params)]
                model = _model_seconds(m, params)
                obs = self.observed_seconds(m)
                d["model_seconds"] = model
                d["rel_error"] = (model - obs) / obs
                out.append(d)
            return out

        return {
            "schema": CALIBRATION_SCHEMA,
            "name": self.name,
            "base": self.base.name,
            # who/what/when produced these numbers (git sha, library
            # versions, the device, hostname, wall clock)
            "provenance": provenance(),
            "estimator": self.estimator,
            "peak_flops": self.peak_flops,
            "hbm_bw": self.hbm_bw,
            "net_bw": self.net_bw,
            "alpha_compute": self.alpha_compute,
            "alpha_memory": self.alpha_memory,
            "alpha_network": self.alpha_network,
            "compute_eff": self.compute_eff.to_dict(),
            "extra_links": dict(self.spec().extra_links),
            "link_alphas": dict(self.link_alphas),
            "vmem_bytes": self.base.vmem_bytes,
            "hbm_capacity_bytes": self.base.hbm_capacity_bytes,
            "ckpt_bw": self.base.ckpt_bw,
            "sources": dict(self.sources),
            "datasheet": {"peak_flops": self.base.peak_flops,
                          "hbm_bw": self.base.hbm_bw,
                          "net_bw": self.base.net_bw,
                          "extra_links": dict(self.base.extra_links)},
            "fit": {"iterations": self.iterations,
                    **self.error_summary("fit")},
            "validation": self.error_summary("validation"),
            "measurements": dump(self.fit_measurements),
            "validation_measurements": dump(self.validation_measurements),
        }

    def save(self, registry_dir: Optional[str] = None) -> str:
        if self.name in PRESETS:
            raise ValueError(
                f"calibration name {self.name!r} shadows a datasheet preset "
                f"(get_hardware would never resolve it); pick another, e.g. "
                f"{self.name + CALIBRATED_SUFFIX!r}")
        cdir = calibration_dir(registry_dir)
        os.makedirs(cdir, exist_ok=True)
        path = os.path.join(cdir, f"{self.name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def summary(self) -> str:
        lines = [f"calibration {self.name} (base {self.base.name}, "
                 f"estimator {self.estimator}, "
                 f"{self.iterations} fit iterations)"]
        datasheet = (self.base.peak_flops, self.base.hbm_bw, self.base.net_bw)
        units = ("s/exec", "s/exec", "s/hop")
        for r, a, fitted, alpha, ds, unit in zip(
                _RESOURCES, _ALPHAS, self.peaks, self.alphas, datasheet,
                units):
            lines.append(
                f"  {r:>10}: {fitted:.4g} ({self.sources[r]}; datasheet "
                f"{ds:.4g}, x{fitted / ds:.3f}) "
                f"{a}={alpha:.3g} {unit}")
        if not self.compute_eff.is_identity:
            e = self.compute_eff
            lines.append(
                f"  compute_eff: eff(F) = "
                f"{e.eff_min:.2g} + {1 - e.eff_min:.2g}/"
                f"(1 + ({e.f_half:.3g}/F)^{e.p:.3g})   "
                f"[eff(1e6)={e.eff(1e6):.2f}, eff(1e9)={e.eff(1e9):.2f}]")
        for tag in sorted(self.base.extra_links):
            bw = self.link_bws.get(tag, self.base.extra_links[tag])
            src = self.sources.get(f"link:{tag}", "datasheet")
            lines.append(
                f"  link {tag:>6}: {bw:.4g} ({src}; datasheet "
                f"{self.base.extra_links[tag]:.4g}) "
                f"alpha={self.link_alphas.get(tag, self.alpha_network):.3g} "
                f"s/hop")
        for which in ("fit", "validation"):
            s = self.error_summary(which)
            if s["n"]:
                lines.append(
                    f"  {which}: n={s['n']} median |rel err| "
                    f"{100 * s['median_abs_rel_error']:.1f}% max "
                    f"{100 * s['max_abs_rel_error']:.1f}%")
        return "\n".join(lines)


def load_calibration_dict(name: str,
                          registry_dir: Optional[str] = None) -> Dict:
    """The raw registry JSON for ``name`` (spec loading lives in hardware)."""
    path = os.path.join(calibration_dir(registry_dir), f"{name}.json")
    with open(path) as f:
        return json.load(f)


def fit_ceilings(measurements: Sequence[Measurement],
                 base: HardwareSpec, *,
                 name: Optional[str] = None,
                 validation: Sequence[Measurement] = (),
                 estimator: str = "best",
                 max_iterations: int = 32) -> Calibration:
    """Per-resource α–β least-squares fit of the machine parameters.

    Fit measurements are grouped by ``category`` (the resource their bench
    saturates by construction) and network points further by link tag; each
    group solves ``t ≈ α·u + q/peak`` (module docstring has the rationale
    for dropping the v1 Lloyd re-assignment).  ``validation`` points (e.g.
    whole model steps) only contribute to the reported error.  Resources
    and links with no measurements keep the datasheet ``base`` numbers
    (α = 0).  ``estimator`` picks the wall-time statistic (see
    :data:`ESTIMATORS`).  ``max_iterations`` is accepted for API
    compatibility and ignored.
    """
    if not measurements:
        raise ValueError("need at least one measurement to fit")
    if estimator not in ESTIMATORS:
        raise ValueError(f"estimator {estimator!r} not in {ESTIMATORS}")
    del max_iterations  # category grouping needs no alternation (see above)
    groups = {"compute": 0, "memory": 1, "network": 2}
    # whole-step points can never constrain a per-resource fit; when the
    # caller hands a full suite (e.g. microbench.default_suite()) route
    # them to validation rather than silently counting them as fit evidence
    steps = [m for m in measurements if m.category not in groups]
    measurements = [m for m in measurements if m.category in groups]
    validation = tuple(validation) + tuple(steps)
    if not measurements:
        raise ValueError("need at least one compute/memory/network "
                         "measurement to fit (step points only validate)")
    params = _Params.from_spec(base)
    measured_links: set = set()
    fitted = [False, False, False]
    # compute / memory: one execution pays one α (u = 1)
    by_resource = {}
    for r in (0, 1):
        pts = [(1.0, _quantities(m)[r], _observed(m, estimator))
               for m in measurements if groups.get(m.category) == r]
        by_resource[r] = pts
        if pts:
            with trace.span(f"calibrate.fit.{('compute', 'memory')[r]}",
                            n_points=len(pts)):
                params.alphas[r], params.peaks[r] = \
                    _fit_alpha_beta(pts, params.peaks[r])
            fitted[r] = True
    # compute only: also try the size-dependent efficiency ceiling and keep
    # whichever model (constant intercept vs saturating curve) prices the
    # sized-GEMM points with less squared error; ties keep α–β, so exact
    # synthetic α–β suites — and any spec that is genuinely latency-plus-
    # constant-ceiling — are reproduced unchanged
    cpts = by_resource[0]
    if cpts:
        with trace.span("calibrate.fit.efficiency", n_points=len(cpts)):
            eff_fit = _fit_efficiency(cpts)
    else:
        eff_fit = None
    if eff_fit is not None:
        peak_eff, eff_model = eff_fit
        sse_ab = _sse(cpts, lambda u, q, a=params.alphas[0],
                      pk=params.peaks[0]: a * u + (q / pk if pk > 0 else 0.0))
        sse_eff = _sse(cpts, lambda u, q, pk=peak_eff, em=eff_model:
                       q / (pk * em.eff(q)) if q > 0 else 0.0)
        if sse_eff < sse_ab:
            params.alphas[0] = 0.0       # the curve subsumes the intercept
            params.peaks[0] = peak_eff
            params.compute_eff = eff_model
    # network: α multiplies serialized hops, fitted per link tag
    by_link: Dict[Optional[str], List[Tuple[float, float, float]]] = {}
    for m in measurements:
        if groups.get(m.category) != 2:
            continue
        tag = None if _is_primary(m.link) else m.link
        by_link.setdefault(tag, []).append(
            (m.work.net_steps, m.work.net_bytes, _observed(m, estimator)))
    for tag, pts in by_link.items():
        with trace.span("calibrate.fit.network",
                        link=tag or "primary", n_points=len(pts)):
            if tag is None:
                params.alphas[2], params.peaks[2] = \
                    _fit_alpha_beta(pts, params.peaks[2])
                fitted[2] = True
            else:
                prior = params.link_bws.get(tag, params.peaks[2])
                alpha, bw = _fit_alpha_beta(pts, prior)
                params.link_alphas[tag] = alpha
                params.link_bws[tag] = bw
                measured_links.add(tag)
    iterations = 1
    sources = {res: ("measured" if fitted[r] else "datasheet")
               for r, res in enumerate(_RESOURCES)}
    for tag in set(base.extra_links) | measured_links:
        sources[f"link:{tag}"] = ("measured" if tag in measured_links
                                  else "datasheet")
    # only persist per-link parameters that were actually fitted — the
    # spec() fallback keeps unmeasured links at their datasheet values
    link_bws = {t: params.link_bws[t] for t in measured_links}
    link_alphas = {t: params.link_alphas[t] for t in measured_links}
    return Calibration(
        name=name or base.name + CALIBRATED_SUFFIX,
        base=base,
        peak_flops=params.peaks[0], hbm_bw=params.peaks[1],
        net_bw=params.peaks[2],
        sources=sources, iterations=iterations,
        fit_measurements=tuple(measurements),
        validation_measurements=tuple(validation),
        estimator=estimator,
        alpha_compute=params.alphas[0],
        alpha_memory=params.alphas[1],
        alpha_network=params.alphas[2],
        link_bws=link_bws, link_alphas=link_alphas,
        compute_eff=params.compute_eff,
    )


# --- CLI ----------------------------------------------------------------------


def _init_ranks(device: Optional[str]) -> Optional[str]:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE`` > 1),
    NCCL on cards and gloo on the CPU; each rank takes its local card.
    Returns the device this rank measures on."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world < 2:
        return device
    cpu = device is not None and torch.device(device).type == "cpu"
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
    if cpu:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    return f"cuda:{local}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.measure.calibrate",
        description="Measure the card and fit achievable Ridgeline "
                    "ceilings (PEAK/HBM/NET).")
    ap.add_argument("--hardware", default="h100_sxm_fp32",
                    help="datasheet preset to calibrate against "
                         "(initialization + fallback for unmeasured "
                         "resources)")
    ap.add_argument("--device", default=None,
                    help="torch device to measure (default: the card; "
                         "'cpu' runs the plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smaller GEMM, stream and collective sizes")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repeats per bench and pass "
                         "(default 9 smoke / 11 full, x3 merged passes)")
    ap.add_argument("--estimator", default="best", choices=ESTIMATORS,
                    help="wall-time statistic to fit on: 'best' sample "
                         "or 'median'")
    ap.add_argument("--no-steps", action="store_true",
                    help="skip the whole-step validation benches")
    ap.add_argument("--name", default=None,
                    help="registry entry name (default <hardware>_cal)")
    ap.add_argument("--out", default=None,
                    help="registry directory (default "
                         "$REPRO_TORCH_CALIBRATION_DIR, else "
                         "artifacts/calibration_torch)")
    ap.add_argument("--figures", default=None,
                    help="also write overlay figures to this directory "
                         "(written anyway without --out, to figures_torch/ "
                         "beside the registry)")
    args = ap.parse_args(argv)

    try:
        base = get_hardware(args.hardware)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.name in PRESETS:
        print(f"error: --name {args.name!r} shadows a datasheet preset; "
              f"pick another (default: {args.hardware}_cal)", file=sys.stderr)
        return 2

    from repro_torch.measure import microbench
    device = _init_ranks(args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        with trace.span("calibrate.suite", smoke=args.smoke, devices=world):
            suite = microbench.default_suite(
                smoke=args.smoke, repeats=args.repeats,
                steps=not args.no_steps, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return 0
    fit = [m for m in suite if m.category != "step"]
    steps = [m for m in suite if m.category == "step"]
    if not any(m.category == "network" for m in fit):
        print("note: one rank -> no collective benches; NET ceiling stays "
              "datasheet (run under torchrun with 2+ ranks)",
              file=sys.stderr)
    with trace.span("calibrate.fit", n_fit=len(fit),
                    n_validation=len(steps)):
        calib = fit_ceilings(fit, base, name=args.name, validation=steps,
                             estimator=args.estimator)
    path = calib.save(args.out)
    print(calib.summary())
    print(f"wrote {path}")

    from repro_torch.measure import overlay
    for p in overlay.write_measured_cells(calib, registry_dir=args.out):
        print(f"wrote {p}")
    if args.figures or not args.out:
        # the port's own sibling of the registry: the reference's default,
        # figures/, is the JAX package's committed artifacts/figures/
        figdir = args.figures or os.path.join(
            os.path.dirname(calibration_dir(args.out)), "figures_torch")
        for p in overlay.write_calibration_figs(figdir, calib):
            print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
