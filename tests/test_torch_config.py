"""The port's config registry equals ``repro.configs`` field by field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro_torch import configs as torch_configs

#: fields whose names differ between the packages
RENAMED = {"use_pallas_matmul": "use_kernel_matmul"}


def _dtype(d):
    """The reference's numpy/ml_dtypes dtype as the port's torch dtype."""
    if np.dtype(d) == np.dtype(jnp.bfloat16):
        return torch.bfloat16
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float16): torch.float16}[np.dtype(d)]


def test_registry_lists_the_same_archs():
    assert torch_configs.list_archs() == jax_configs.list_archs()
    assert torch_configs.ASSIGNED == jax_configs.ASSIGNED


@pytest.mark.parametrize("getter", ["get_config", "get_reduced"])
@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_every_field_matches(arch, getter):
    want = getattr(jax_configs, getter)(arch)
    got = getattr(torch_configs, getter)(arch)
    want_names = {RENAMED.get(f.name, f.name)
                  for f in dataclasses.fields(want)}
    assert {f.name for f in dataclasses.fields(got)} == want_names
    for f in dataclasses.fields(want):
        value = getattr(want, f.name)
        if f.name in ("compute_dtype", "param_dtype"):
            value = _dtype(value)
        assert getattr(got, RENAMED.get(f.name, f.name)) == value, f.name
    if want.n_heads:
        assert (got.dh, got.q_dim, got.kv_dim) == \
            (want.dh, want.q_dim, want.kv_dim)


def test_replace_keeps_the_frozen_dataclass():
    cfg = torch_configs.get_config("dlrm-mlp")
    on = cfg.replace(use_kernel_matmul=True)
    assert on.use_kernel_matmul and not cfg.use_kernel_matmul
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.n_layers = 1
