"""``flash_roofline.prefill``: the attention's FLOPs at the cell's shapes
(``work/lm.attention_flops``: the causal pairs) at the bf16 peak, over the
device time of the flash-attention kernel in a forward, in %."""
from ridgebench.metrics._common import FLASH, per_unit_device_s
from ridgebench.work import lm, peaks


def read(ctx):
    t = per_unit_device_s(ctx, FLASH)
    if t is None:
        return None
    flops = lm.attention_flops(ctx.doc, ctx.work["batch"], ctx.work["seq"])
    return 100.0 * flops / peaks.BF16_FLOPS / t
