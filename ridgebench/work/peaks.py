"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

#: bf16 / fp16 tensor-core rate, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of work on the card: the larger of its operations at
    the bf16 peak and its bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
