"""What the metric readers share: the kernels' names and the work per unit.

A reader is ``metrics/<metric>.py`` with ``read(ctx) -> float | None``;
``None`` where its cell's run has nothing for it to read (the harness then
leaves the metric out of the line).
"""
from __future__ import annotations

from typing import Optional

from ridgebench.work import peaks

#: the blocked-matmul kernel's device functions
#: (``kernels/csrc/blocked_matmul.cu``)
MATMUL = ("gemm_sm90_kernel", "gemm_bf16_kernel", "gemm_f32_kernel",
          "gemm_f32_ring_kernel")
#: the flash-attention kernel's (``kernels/csrc/flash_attention.cu``)
FLASH = ("flash_sm90_kernel", "flash_bf16_kernel", "flash_f32_kernel")
#: PyTorch's float32 -> bfloat16 copy
BF16_COPY = ("bfloat16_copy",)


def mfu(ctx) -> Optional[float]:
    """Model FLOPs of a unit over the bf16 peak, over the mean host seconds
    of the window's untraced units (all their work over all their time)."""
    if not ctx.seconds:
        return None
    per_unit = sum(ctx.seconds) / len(ctx.seconds)
    return 100.0 * ctx.work["flops"] / peaks.BF16_FLOPS / per_unit


def per_unit_device_s(ctx, names) -> Optional[float]:
    """Device seconds a unit of the traced kernels named, None where the
    trace holds none."""
    if ctx.trace.count_of(*names) == 0:
        return None
    return ctx.trace.seconds_of(*names) / ctx.trace.units


def idle_pct(ctx) -> Optional[float]:
    tr = ctx.trace
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
