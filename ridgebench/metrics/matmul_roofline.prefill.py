"""``matmul_roofline.prefill``: the least time of the FFN products the
blocked-matmul kernel runs in a forward (``work/lm.ffn_products``: each the
larger of its FLOPs at the bf16 peak and its inputs and output once at the
HBM peak), over the kernel's device time in a forward, in %."""
from ridgebench.metrics._common import MATMUL, per_unit_device_s
from ridgebench.work import lm, peaks


def read(ctx):
    t = per_unit_device_s(ctx, MATMUL)
    if t is None:
        return None
    least = sum(peaks.least_seconds(*lm.product_work(p)) for p in
                lm.ffn_products(ctx.doc, ctx.work["batch"], ctx.work["seq"]))
    return 100.0 * least / t
