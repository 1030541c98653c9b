"""``mfu.<kind>``: a unit's model FLOPs (``ctx.work["flops"]``, counted by
``work/`` from the configuration) at the bf16 peak, over the unit's mean
host time in the window, in %.  One reader for every kind."""
from ridgebench.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
