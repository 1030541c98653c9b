"""Hardware resource book for Ridgeline analysis on the port's card.

A copy of ``repro.core.hardware``: ``HardwareSpec`` carries the per-chip
peaks the Ridgeline model divides by, the α (latency) terms of the α–β
extension (per link where a link has its own), the size-dependent
achievable-PEAK curve ``EfficiencyModel`` and the device-memory capacity.

Specs come from two sources:

  * **datasheet** presets (``PRESETS``): NVIDIA's numbers for one H100 SXM,
    each naming its source.  They are peaks at the card's full 700 W power
    limit: a card set below it runs slower under load, so every
    measurement against them is reported with the card's power limit.
  * **calibrated** specs: ceilings fitted from timings on the card by
    ``repro_torch.measure.calibrate`` and kept as JSON in the port's own
    registry (``calibration_dir``: ``--out``, else
    ``REPRO_TORCH_CALIBRATION_DIR``, else ``artifacts/calibration_torch/``;
    never the JAX package's ``artifacts/calibration/``).
    ``get_hardware(name, calibrated=True)`` resolves the calibrated twin of
    a preset.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class EfficiencyModel:
    """Size-dependent achievable fraction of a peak: ``eff(q)`` in (0, 1].

        eff(q) = eff_min + (1 - eff_min) / (1 + (f_half / q) ** p)

    a Hill curve in the work-unit quantity ``q`` (FLOPs for the compute
    ceiling): ``f_half`` is the size recovering half the headroom, ``p``
    the sharpness, ``eff_min`` the floor as q -> 0.  The default
    (``f_half == 0``) is the identity ``eff ≡ 1``, which every datasheet
    preset uses and which prices times exactly as a constant ceiling does.
    """

    f_half: float = 0.0      # quantity at half headroom; 0 => identity
    p: float = 1.0           # Hill sharpness exponent
    eff_min: float = 0.0     # efficiency floor as q -> 0

    def __post_init__(self):
        if self.f_half < 0 or self.p <= 0 or not 0.0 <= self.eff_min <= 1.0:
            raise ValueError(
                f"EfficiencyModel needs f_half >= 0, p > 0, eff_min in "
                f"[0, 1]; got {self}")

    @property
    def is_identity(self) -> bool:
        return self.f_half == 0.0

    def eff(self, quantity: float) -> float:
        """Achievable fraction of peak for a work unit of size ``quantity``."""
        if self.f_half <= 0.0:
            return 1.0
        q = float(quantity)
        if q <= 0.0:
            return self.eff_min
        if math.isinf(q):
            return 1.0
        try:
            ratio = (self.f_half / q) ** self.p   # -> inf for tiny q
        except OverflowError:                     # float ** raises past 1e308
            return self.eff_min
        return self.eff_min + (1.0 - self.eff_min) / (1.0 + ratio)

    def to_dict(self) -> Dict[str, float]:
        return {"f_half": self.f_half, "p": self.p, "eff_min": self.eff_min}

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> "EfficiencyModel":
        """Registry JSON -> model; None or empty -> identity."""
        if not d:
            return EfficiencyModel()
        return EfficiencyModel(f_half=float(d.get("f_half", 0.0)),
                               p=float(d.get("p", 1.0)),
                               eff_min=float(d.get("eff_min", 0.0)))


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip resource peaks used as Ridgeline balance points.

    Attributes:
      name: identifier.
      peak_flops: peak compute throughput, FLOP/s, in the dtype of interest.
      hbm_bw: device-memory bandwidth, bytes/s.
      net_bw: primary network bandwidth, bytes/s per chip each way.
      extra_links: optional named slower links, bytes/s, keyed by mesh-axis
        tag.
      alpha_compute: fixed dispatch overhead per work-unit execution, s.
      alpha_memory: fixed per-execution memory-system overhead, s.
      alpha_network: per-hop network latency, s per serialized step.
      link_alphas: per-link α overrides keyed like ``extra_links``; a link
        without an entry takes ``alpha_network``.
      model_rel_error: median |relative error| of a calibration on its
        whole-step validation points (0 for datasheet presets).
      compute_eff: the achievable-PEAK curve: an F-FLOP unit's compute
        ceiling is ``peak_flops · compute_eff.eff(F)``.
      vmem_bytes: fast on-chip scratch per core (the H100's shared memory
        per SM), for kernel tile planning; not used by the Ridgeline.
      hbm_capacity_bytes: device-memory capacity per chip; 0 = unknown.
      ckpt_bw: per-chip bandwidth to checkpoint storage, bytes/s;
        0 = unknown.
    """

    name: str
    peak_flops: float
    hbm_bw: float
    net_bw: float
    extra_links: Mapping[str, float] = dataclasses.field(default_factory=dict)
    alpha_compute: float = 0.0
    alpha_memory: float = 0.0
    alpha_network: float = 0.0
    link_alphas: Mapping[str, float] = dataclasses.field(default_factory=dict)
    model_rel_error: float = 0.0
    compute_eff: EfficiencyModel = EfficiencyModel()
    vmem_bytes: int = 0
    hbm_capacity_bytes: float = 0.0
    ckpt_bw: float = 0.0

    # ---- machine balance points (paper §II, Fig. 2) -------------------------
    @property
    def ridge_arithmetic(self) -> float:
        """y* = Peak / HBM_bw: the classic roofline ridge (FLOP/mem-byte)."""
        return self.peak_flops / self.hbm_bw

    @property
    def ridge_memory(self) -> float:
        """x* = HBM_bw / Net_bw: memory-network balance (mem-byte/net-byte)."""
        return self.hbm_bw / self.net_bw

    @property
    def ridge_network(self) -> float:
        """k* = Peak / Net_bw: compute-network balance (FLOP/net-byte)."""
        return self.peak_flops / self.net_bw

    #: names that always resolve to the primary link
    PRIMARY_LINKS = (None, "ici", "net")

    def bandwidth_for(self, link: Optional[str] = None) -> float:
        """Bandwidth of a named link; unknown names raise with the options."""
        if link in self.PRIMARY_LINKS:
            return self.net_bw
        try:
            return float(self.extra_links[link])
        except KeyError:
            raise KeyError(
                f"hardware spec {self.name!r} has no network link {link!r}; "
                f"available links: primary ('net'/'ici'/None) plus "
                f"extra_links {sorted(self.extra_links) or '{}'}") from None

    def alpha_for(self, link: Optional[str] = None) -> float:
        """Per-hop α of a named link (falls back to ``alpha_network``)."""
        if link not in self.PRIMARY_LINKS and link not in self.extra_links:
            self.bandwidth_for(link)           # raise the actionable KeyError
        return float(self.link_alphas.get(link, self.alpha_network))


# --- Presets -----------------------------------------------------------------

#: NVIDIA H100 SXM5, datasheet (dense, no sparsity): 989 TFLOP/s bf16 tensor
#: core, 3.35 TB/s HBM3, 80 GB; NVLink 4 at 900 GB/s total = 450 GB/s each
#: way; 228 KB of shared memory per SM.
#:
#: ``pod`` is the network between nodes (the planner's ``--pod-size``): a
#: DGX H100 board gives each GPU its own ConnectX-7 at InfiniBand NDR
#: 400 Gb/s = 50 GB/s each way (NVIDIA's DGX H100 datasheet).
#:
#: ``ckpt_bw`` (the planner's ``--goodput``) is measured, not a datasheet
#: number: ``chip_smoke.py``'s ``train_cli`` phase saved smollm-135m's
#: training state, 1,614,374,844 bytes, synchronously in 3.130 s on the
#: host of an NVIDIA H100 80GB HBM3 at its 700 W limit (PERF.md), about
#: 0.52 GB/s to local disk through the port's checkpointer.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    net_bw=450e9,
    extra_links={"pod": 50e9},
    vmem_bytes=228 * 1024,
    hbm_capacity_bytes=80e9,
    ckpt_bw=1_614_374_844 / 3.130,
)

#: The same card priced for fp32 work outside the tensor cores (datasheet:
#: 67 TFLOP/s FP32), used for the fp32 calibration GEMMs.
H100_SXM_FP32 = dataclasses.replace(H100_SXM, name="h100_sxm_fp32",
                                    peak_flops=67e12)

#: Intel Xeon Cascade Lake socket exactly as in the paper's case study (§III):
#: 4.2 TF/s FP32, 105 GB/s DRAM, 12 GB/s network per socket.  The paper's own
#: machine, copied from the JAX package's presets; the examples place the
#: DLRM tower on it as the paper does.
CLX = HardwareSpec(
    name="clx",
    peak_flops=4.2e12,
    hbm_bw=105e9,
    net_bw=12e9,
    vmem_bytes=36 * 1024 * 1024,  # LLC, unused in analysis
    hbm_capacity_bytes=192e9,     # 6-channel DDR4 socket, 32 GB DIMMs
    ckpt_bw=2e9,                  # local NVMe per socket
)

PRESETS: Dict[str, HardwareSpec] = {"h100_sxm": H100_SXM,
                                    "h100_sxm_fp32": H100_SXM_FP32,
                                    "clx": CLX}


# --- calibration registry -----------------------------------------------------

#: JSON schema tag of a registry entry: the α–β fit plus the ``compute_eff``
#: curve (the JAX package's v3; the port reads no older entry)
CALIBRATION_SCHEMA = "repro.calibration/v3"

#: suffix convention: the calibrated twin of ``h100_sxm_fp32`` is
#: ``h100_sxm_fp32_cal``
CALIBRATED_SUFFIX = "_cal"


def calibration_dir(registry_dir: Optional[str] = None) -> str:
    """Where the port's calibrated specs live: explicit arg > env > default.

    The default resolves relative to this source tree
    (``<repo>/artifacts/calibration_torch``) so CLIs work from any cwd.
    """
    if registry_dir is not None:
        return registry_dir
    env = os.environ.get("REPRO_TORCH_CALIBRATION_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))  # src/repro_torch/core
    return os.path.join(root, "artifacts", "calibration_torch")


def spec_from_calibration(d: Mapping) -> HardwareSpec:
    """Build a HardwareSpec from one calibration-registry JSON dict."""
    schema = d.get("schema")
    if schema != CALIBRATION_SCHEMA:
        raise ValueError(
            f"calibration entry {d.get('name')!r} has schema {schema!r}, "
            f"expected {CALIBRATION_SCHEMA!r}")
    validation = d.get("validation", {}) or {}
    return HardwareSpec(
        name=str(d["name"]),
        peak_flops=float(d["peak_flops"]),
        hbm_bw=float(d["hbm_bw"]),
        net_bw=float(d["net_bw"]),
        extra_links={k: float(v)
                     for k, v in dict(d.get("extra_links", {})).items()},
        alpha_compute=float(d.get("alpha_compute", 0.0)),
        alpha_memory=float(d.get("alpha_memory", 0.0)),
        alpha_network=float(d.get("alpha_network", 0.0)),
        link_alphas={k: float(v)
                     for k, v in dict(d.get("link_alphas", {})).items()},
        model_rel_error=float(validation.get("median_abs_rel_error", 0.0)),
        compute_eff=EfficiencyModel.from_dict(d.get("compute_eff")),
        vmem_bytes=int(d.get("vmem_bytes", 0)),
        hbm_capacity_bytes=float(d.get("hbm_capacity_bytes", 0.0)),
        ckpt_bw=float(d.get("ckpt_bw", 0.0)),
    )


def _read_calibration_entry(path: str) -> Optional[Dict]:
    """One registry file as a dict, or None if unreadable or off-schema."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or d.get("schema") != CALIBRATION_SCHEMA:
        return None
    return d


def load_calibrated(name: str,
                    registry_dir: Optional[str] = None) -> HardwareSpec:
    """Load a calibrated spec by its own name or by its base preset's name.

    Only ever raises KeyError (corrupt or off-schema entries are skipped).
    """
    cdir = calibration_dir(registry_dir)
    candidates = [os.path.join(cdir, name + ".json"),
                  os.path.join(cdir, name + CALIBRATED_SUFFIX + ".json")]
    if os.path.isdir(cdir):
        candidates += [os.path.join(cdir, fn)
                       for fn in sorted(os.listdir(cdir))
                       if fn.endswith(".json")]
    for path in candidates:
        d = _read_calibration_entry(path) if os.path.isfile(path) else None
        if d is None:
            continue
        base = os.path.basename(path)[:-len(".json")]
        if base == name or d.get("name") == name or d.get("base") == name:
            return spec_from_calibration(d)
    calibrated = sorted(n for n, src in list_hardware(registry_dir).items()
                        if src == "calibrated")
    raise KeyError(
        f"no calibration for {name!r} under {cdir}; run "
        f"`python -m repro_torch.measure.calibrate` first "
        f"(calibrated specs available: {calibrated or 'none'})")


def list_hardware(registry_dir: Optional[str] = None) -> Dict[str, str]:
    """All resolvable spec names -> source ('datasheet' | 'calibrated');
    a registry entry whose name shadows a preset is skipped."""
    out = {name: "datasheet" for name in PRESETS}
    cdir = calibration_dir(registry_dir)
    if os.path.isdir(cdir):
        for fn in sorted(os.listdir(cdir)):
            if not fn.endswith(".json"):
                continue
            d = _read_calibration_entry(os.path.join(cdir, fn))
            if d is not None and "name" in d and d["name"] not in PRESETS:
                out[str(d["name"])] = "calibrated"
    return out


def get_hardware(name: str, *, calibrated: bool = False,
                 registry_dir: Optional[str] = None) -> HardwareSpec:
    """Resolve a spec by name.

    ``calibrated=True`` demands the measured twin (KeyError if never
    calibrated).  Otherwise presets win, and names found only in the
    registry (``h100_sxm_fp32_cal``) still resolve.
    """
    if calibrated:
        return load_calibrated(name, registry_dir)
    if name in PRESETS:
        return PRESETS[name]
    try:
        return load_calibrated(name, registry_dir)
    except KeyError:
        pass
    raise KeyError(f"unknown hardware spec {name!r}; "
                   f"have {sorted(list_hardware(registry_dir))}")
