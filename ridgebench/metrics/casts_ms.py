"""``casts_ms.<kind>``: device ms a unit of PyTorch's float32 -> bfloat16
copies: the weights cast at each use (the FFN's and experts' products, the
head) and the norms' outputs.  One reader for every kind."""
from ridgebench.metrics._common import BF16_COPY, per_unit_device_s


def read(ctx):
    t = per_unit_device_s(ctx, BF16_COPY)
    return None if t is None else 1e3 * t
