"""``device.idle_pct.<kind>``: the share of the traced stretch of whole
units in which no operation ran on the device, in %.  One reader for every
kind."""
from ridgebench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
