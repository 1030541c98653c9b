"""The Ridgeline model and the H100 hardware spec, copied from ``repro.core``
(the port imports nothing of ``repro``)."""
