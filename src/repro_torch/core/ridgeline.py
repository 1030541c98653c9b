"""The Ridgeline model (paper §II), copied from ``repro.core.ridgeline``.

A *work unit* is characterized by F (FLOPs), B_M (memory bytes) and B_N
(network bytes).  On a machine (``HardwareSpec``) its resource times are

    t_C = α_C + F / (PEAK · eff(F))   (α_C only when F > 0)
    t_M = α_M + B_M / HBM     (α_M only when B_M > 0)
    t_N = α_N · steps + B_N / NET

its bottleneck is the argmax (ties COMPUTE > MEMORY > NETWORK), and the
least time it can take is ``max(t_C, t_M, t_N)``.  The plane coordinates are
x = I_M = B_M / B_N and y = I_A = F / B_M.  ``eff`` is the spec's
``compute_eff`` curve: the identity on datasheet specs, fitted by the
calibration.

The paper's construction (Fig. 2) classifies by the plane alone: with
x* = HBM/NET, y* = PEAK/HBM and k* = PEAK/NET, a point right of x* is
COMPUTE above y* and MEMORY below it; left of x* it is NETWORK below y*,
and above y* COMPUTE or NETWORK by the hyperbola x·y ≶ k*
(``classify_by_quadrant``).  Where α = 0 and eff ≡ 1 (every datasheet
preset) that equals the argmax of the times (``classify_by_times``), the
paper's theorem; with a fitted α or eff(F) the times are the physical
definition and the plane is the bandwidth-only picture.  ``ascii_plot`` and
``svg_plot`` draw the plane; their text is the reference's, byte for byte.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.hardware import HardwareSpec


class Resource(enum.Enum):
    COMPUTE = "compute"
    MEMORY = "memory"
    NETWORK = "network"


def _safe_div(a: float, b: float) -> float:
    if b == 0:
        return math.inf if a > 0 else 0.0
    return a / b


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    """The three Ridgeline characteristics of a kernel / step / program,
    per compute entity (per chip)."""

    name: str
    flops: float          # F
    mem_bytes: float      # B_M
    net_bytes: float      # B_N  (wire bytes per chip; 0 for single-chip work)
    net_steps: float = 0.0  # serialized network hops (the α multiplier)

    def __post_init__(self):
        if self.flops < 0 or self.mem_bytes < 0 or self.net_bytes < 0 \
                or self.net_steps < 0:
            raise ValueError(f"negative resource count in {self}")

    @property
    def arithmetic_intensity(self) -> float:
        """I_A = F / B_M (FLOP per memory byte) — the y axis."""
        return _safe_div(self.flops, self.mem_bytes)

    @property
    def memory_intensity(self) -> float:
        """I_M = B_M / B_N (memory byte per network byte) — the x axis."""
        return _safe_div(self.mem_bytes, self.net_bytes)

    @property
    def network_intensity(self) -> float:
        """I_N = F / B_N = I_A · I_M (FLOP per network byte)."""
        return _safe_div(self.flops, self.net_bytes)


@dataclasses.dataclass(frozen=True)
class RidgelineAnalysis:
    """Full placement of one WorkUnit on one machine."""

    work: WorkUnit
    hw: HardwareSpec
    t_compute: float                 # seconds
    t_memory: float
    t_network: float
    bottleneck: Resource
    runtime: float                   # max of the three times (projected bound)
    attained_flops: float            # F / runtime
    peak_fraction: float             # attained / peak == t_compute / runtime
    x: float                         # I_M
    y: float                         # I_A

    def resource_times(self) -> Dict[Resource, float]:
        return {
            Resource.COMPUTE: self.t_compute,
            Resource.MEMORY: self.t_memory,
            Resource.NETWORK: self.t_network,
        }

    def summary(self) -> str:
        return (
            f"{self.work.name}: I_A={self.y:.3g} I_M={self.x:.3g} "
            f"I_N={self.work.network_intensity:.3g} | "
            f"t_C={self.t_compute:.3e}s t_M={self.t_memory:.3e}s "
            f"t_N={self.t_network:.3e}s -> {self.bottleneck.value.upper()} "
            f"bound, {100 * self.peak_fraction:.1f}% of peak"
        )


def classify_by_quadrant(work: WorkUnit, hw: HardwareSpec) -> Resource:
    """Bottleneck via the paper's 2D plane construction (Fig. 2c/2e).

    Kept literally quadrant-based (not argmax-based) so that the equivalence
    with :func:`classify_by_times` is a *checked theorem*, not a tautology.
    Boundary convention: ties go COMPUTE > MEMORY > NETWORK (a point exactly
    on a ridge attains peak for both resources; we report the "better" one).
    """
    if work.flops == 0 and work.mem_bytes == 0 and work.net_bytes == 0:
        return Resource.COMPUTE  # degenerate empty unit; matches argmax tie-break
    x, y = work.memory_intensity, work.arithmetic_intensity
    x_star, y_star = hw.ridge_memory, hw.ridge_arithmetic
    if x >= x_star and y >= y_star:
        return Resource.COMPUTE
    if x >= x_star and y < y_star:
        return Resource.MEMORY
    if x < x_star and y < y_star:
        return Resource.NETWORK
    # upper-left: compare the hyperbola x*y against k* (paper Fig. 2d)
    xy = work.network_intensity  # == x * y, but exact when B_M cancels
    return Resource.COMPUTE if xy >= hw.ridge_network else Resource.NETWORK


def resource_times(work: WorkUnit, hw: HardwareSpec,
                   link: Optional[str] = None
                   ) -> Tuple[float, float, float]:
    """The α-aware (t_C, t_M, t_N); α's of 0 give the paper's pure-β times.

    ``link`` names the network link the wire bytes rode (None = primary).
    The compute ceiling is ``PEAK · eff(F)`` (``hw.compute_eff``); the
    identity curve multiplies by exactly 1.0, so a spec without a fitted
    curve prices times as a constant ceiling does, bit for bit.
    """
    t_c = (hw.alpha_compute if work.flops > 0 else 0.0) + \
        _safe_div(work.flops,
                  hw.peak_flops * hw.compute_eff.eff(work.flops))
    t_m = (hw.alpha_memory if work.mem_bytes > 0 else 0.0) + \
        _safe_div(work.mem_bytes, hw.hbm_bw)
    t_n = hw.alpha_for(link) * work.net_steps + \
        _safe_div(work.net_bytes, hw.bandwidth_for(link))
    return t_c, t_m, t_n


def _classify_times(t_c: float, t_m: float, t_n: float) -> Resource:
    """Argmax of three times, COMPUTE > MEMORY > NETWORK on ties."""
    if t_c >= t_m:
        return Resource.COMPUTE if t_c >= t_n else Resource.NETWORK
    return Resource.MEMORY if t_m >= t_n else Resource.NETWORK


def classify_by_times(work: WorkUnit, hw: HardwareSpec) -> Resource:
    """Bottleneck as argmax of the α-aware times (the physical definition).

    Equals :func:`classify_by_quadrant` whenever the spec's α terms are zero
    (the checked theorem); with α > 0 this is the ground truth and the
    quadrant construction remains the bandwidth-only plane picture.
    """
    return _classify_times(*resource_times(work, hw))


def analyze(work: WorkUnit, hw: HardwareSpec) -> RidgelineAnalysis:
    t_c, t_m, t_n = resource_times(work, hw)
    runtime = max(t_c, t_m, t_n)
    attained = _safe_div(work.flops, runtime) if runtime > 0 else 0.0
    return RidgelineAnalysis(
        work=work,
        hw=hw,
        t_compute=t_c,
        t_memory=t_m,
        t_network=t_n,
        bottleneck=_classify_times(t_c, t_m, t_n),
        runtime=runtime,
        attained_flops=attained,
        peak_fraction=_safe_div(attained, hw.peak_flops),
        x=work.memory_intensity,
        y=work.arithmetic_intensity,
    )


def analyze_multilink(
    work_per_link: Mapping[str, WorkUnit], hw: HardwareSpec
) -> RidgelineAnalysis:
    """Beyond-paper: Ridgeline with a multi-level network.

    ``work_per_link`` maps link tag -> WorkUnit whose ``net_bytes`` (and
    ``net_steps``) are the wire traffic on that link (flops/mem_bytes
    identical across entries).  Each link's time is α–β priced with *its
    own* bandwidth and per-hop α; the effective network time is the max over
    links, folded back into a single equivalent WorkUnit by scaling B_N to
    primary-link units so the 2D plane still applies (the plane is defined
    up to the choice of network).
    """
    if not work_per_link:
        raise ValueError("need at least one link")
    items = list(work_per_link.items())
    base = items[0][1]
    t_net = 0.0
    for tag, w in items:
        bw = hw.bandwidth_for(tag)
        t_link = hw.alpha_for(tag) * w.net_steps + _safe_div(w.net_bytes, bw)
        t_net = max(t_net, t_link)
    eff_net_bytes = t_net * hw.net_bw  # primary-link-equivalent bytes
    # steps fold into the equivalent bytes, so the folded unit carries none
    eff = WorkUnit(base.name, base.flops, base.mem_bytes, eff_net_bytes)
    return analyze(eff, hw)


# --- Region geometry for plotting -------------------------------------------

def region_at(x: float, y: float, hw: HardwareSpec) -> Resource:
    """Region of an arbitrary plane point (used by plotting/tests)."""
    return classify_by_quadrant(WorkUnit("pt", x * y, x, 1.0), hw)
    # note: B_N=1, B_M=x, F=x*y reproduces coordinates (x, y) exactly.


def ascii_plot(
    analyses: Sequence[RidgelineAnalysis],
    hw: HardwareSpec,
    width: int = 72,
    height: int = 24,
    x_range: Optional[Tuple[float, float]] = None,
    y_range: Optional[Tuple[float, float]] = None,
    point_notes: Optional[Mapping[str, str]] = None,
) -> str:
    """Log-log ASCII Ridgeline plot: region letters + labelled points.

    Regions: ``.`` network, ``-`` memory, ``+`` compute. Points: digits
    indexing into ``analyses`` (shown in the legend).  ``point_notes`` maps
    a work-unit name to an annotation appended to its legend line — the
    measured-overlay path uses it for wall times and model error.
    """
    point_notes = point_notes or {}
    finite = [a for a in analyses if math.isfinite(a.x) and math.isfinite(a.y)
              and a.x > 0 and a.y > 0]
    xs = [a.x for a in finite] + [hw.ridge_memory]
    ys = [a.y for a in finite] + [hw.ridge_arithmetic]
    if x_range is None:
        x_range = (min(xs) / 8, max(xs) * 8)
    if y_range is None:
        y_range = (min(ys) / 8, max(ys) * 8)
    lx0, lx1 = math.log10(x_range[0]), math.log10(x_range[1])
    ly0, ly1 = math.log10(y_range[0]), math.log10(y_range[1])

    def to_col(x: float) -> int:
        return int(round((math.log10(x) - lx0) / (lx1 - lx0) * (width - 1)))

    def to_row(y: float) -> int:
        return (height - 1) - int(
            round((math.log10(y) - ly0) / (ly1 - ly0) * (height - 1))
        )

    glyph = {Resource.NETWORK: ".", Resource.MEMORY: "-", Resource.COMPUTE: "+"}
    grid = []
    for r in range(height):
        ly = ly1 - (ly1 - ly0) * r / (height - 1)
        row = []
        for c in range(width):
            lx = lx0 + (lx1 - lx0) * c / (width - 1)
            row.append(glyph[region_at(10 ** lx, 10 ** ly, hw)])
        grid.append(row)

    # ridge crosshair
    xc, yr = to_col(hw.ridge_memory), to_row(hw.ridge_arithmetic)
    for r in range(height):
        if 0 <= xc < width:
            grid[r][xc] = "|"
    for c in range(width):
        if 0 <= yr < height:
            grid[yr][c] = "="
    if 0 <= yr < height and 0 <= xc < width:
        grid[yr][xc] = "*"

    legend = []
    for i, a in enumerate(finite):
        ch = str(i % 10) if i < 10 else chr(ord("a") + (i - 10) % 26)
        r, c = to_row(a.y), to_col(a.x)
        if 0 <= r < height and 0 <= c < width:
            grid[r][c] = ch
        note = point_notes.get(a.work.name)
        legend.append(
            f"  [{ch}] {a.work.name}: ({a.x:.3g}, {a.y:.3g}) -> "
            f"{a.bottleneck.value}" + (f" | {note}" if note else "")
        )

    header = (
        f"Ridgeline plane for {hw.name} "
        f"(x*={hw.ridge_memory:.3g} mem-B/net-B, "
        f"y*={hw.ridge_arithmetic:.3g} FLOP/mem-B, "
        f"k*={hw.ridge_network:.3g} FLOP/net-B)\n"
        f"regions: '.'=network  '-'=memory  '+'=compute; "
        f"x: I_M=B_M/B_N (log), y: I_A=F/B_M (log)\n"
    )
    body = "\n".join("".join(row) for row in grid)
    return header + body + "\n" + "\n".join(legend)


def svg_plot(
    analyses: Sequence[RidgelineAnalysis],
    hw: HardwareSpec,
    width: int = 640,
    height: int = 480,
    point_notes: Optional[Mapping[str, str]] = None,
) -> str:
    """Self-contained SVG Ridgeline plot (no plotting deps available).

    Points named in ``point_notes`` render as hollow "measured" markers with
    the note under the label (used for model-vs-measured overlays).
    """
    point_notes = point_notes or {}
    finite = [a for a in analyses if a.x > 0 and a.y > 0
              and math.isfinite(a.x) and math.isfinite(a.y)]
    xs = [a.x for a in finite] + [hw.ridge_memory]
    ys = [a.y for a in finite] + [hw.ridge_arithmetic]
    lx0, lx1 = math.log10(min(xs) / 10), math.log10(max(xs) * 10)
    ly0, ly1 = math.log10(min(ys) / 10), math.log10(max(ys) * 10)
    m = 50  # margin

    def px(x):
        return m + (math.log10(x) - lx0) / (lx1 - lx0) * (width - 2 * m)

    def py(y):
        return height - m - (math.log10(y) - ly0) / (ly1 - ly0) * (height - 2 * m)

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
    ]
    # region shading via coarse raster
    cols, rows = 64, 48
    fill = {Resource.NETWORK: "#fde0dd", Resource.MEMORY: "#e0ecf4",
            Resource.COMPUTE: "#e5f5e0"}
    cw, ch = (width - 2 * m) / cols, (height - 2 * m) / rows
    for i in range(cols):
        for j in range(rows):
            lx = lx0 + (lx1 - lx0) * (i + 0.5) / cols
            ly = ly0 + (ly1 - ly0) * (j + 0.5) / rows
            reg = region_at(10 ** lx, 10 ** ly, hw)
            x0 = m + i * cw
            y0 = height - m - (j + 1) * ch
            parts.append(
                f'<rect x="{x0:.1f}" y="{y0:.1f}" width="{cw + 0.5:.1f}" '
                f'height="{ch + 0.5:.1f}" fill="{fill[reg]}"/>'
            )
    # ridges
    parts.append(
        f'<line x1="{px(hw.ridge_memory):.1f}" y1="{m}" '
        f'x2="{px(hw.ridge_memory):.1f}" y2="{height - m}" '
        'stroke="#d62728" stroke-dasharray="4"/>'
    )
    parts.append(
        f'<line x1="{m}" y1="{py(hw.ridge_arithmetic):.1f}" '
        f'x2="{width - m}" y2="{py(hw.ridge_arithmetic):.1f}" '
        'stroke="#1f77b4" stroke-dasharray="4"/>'
    )
    # hyperbola x*y = k* (straight in log space)
    hx0, hx1 = 10 ** lx0, 10 ** lx1
    pts = []
    for i in range(65):
        x = 10 ** (lx0 + (lx1 - lx0) * i / 64)
        y = hw.ridge_network / x
        if 10 ** ly0 <= y <= 10 ** ly1:
            pts.append(f"{px(x):.1f},{py(y):.1f}")
    if pts:
        parts.append(
            f'<polyline points="{" ".join(pts)}" fill="none" '
            'stroke="#2ca02c" stroke-dasharray="2"/>'
        )
    for a in finite:
        note = point_notes.get(a.work.name)
        if note is None:
            parts.append(
                f'<circle cx="{px(a.x):.1f}" cy="{py(a.y):.1f}" r="4" '
                'fill="#333"/>')
        else:
            parts.append(
                f'<circle cx="{px(a.x):.1f}" cy="{py(a.y):.1f}" r="5" '
                'fill="none" stroke="#d62728" stroke-width="2" '
                'class="measured"/>')
        parts.append(
            f'<text x="{px(a.x) + 6:.1f}" y="{py(a.y) - 6:.1f}" '
            f'font-size="10" font-family="monospace">{a.work.name}</text>'
        )
        if note:
            parts.append(
                f'<text x="{px(a.x) + 6:.1f}" y="{py(a.y) + 6:.1f}" '
                f'font-size="9" font-family="monospace" '
                f'fill="#d62728">{note}</text>')
    parts.append(
        f'<text x="{width / 2:.0f}" y="{height - 12}" font-size="12" '
        'text-anchor="middle" font-family="monospace">'
        "I_M = B_M / B_N (log)</text>"
        f'<text x="14" y="{height / 2:.0f}" font-size="12" '
        'text-anchor="middle" font-family="monospace" '
        f'transform="rotate(-90 14 {height / 2:.0f})">I_A = F / B_M (log)</text>'
    )
    parts.append("</svg>")
    return "\n".join(parts)
