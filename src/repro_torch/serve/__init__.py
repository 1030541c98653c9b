"""Serving layer: prefill + batched single-token decode (``engine``)."""
