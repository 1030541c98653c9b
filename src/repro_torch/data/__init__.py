"""Synthetic data pipelines feeding the train loop (``pipeline``)."""
