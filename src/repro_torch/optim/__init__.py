"""Functional optimizers over the port's parameter dicts."""
