"""Analytic collective costs (the wire bytes of the Ridgeline's B_N)."""
