"""The port's working-set model against ``repro.launch.memory``.

Both sides take the same configs (the port's and the reference's
``get_config`` of one arch) and the same broadcast candidate arrays: every
(dp, tp, pp, ep, m) mesh of a few chip budgets crossed with the ZeRO stages,
with and without remat.  Every field of every ``WorkingSet``, and
``min_zero_stage`` at a few capacities, must be the reference's array
exactly: it is the same numpy over the same parameter counts.
"""
import numpy as np
import pytest

from repro import configs as jax_configs
from repro.launch import memory as jax_memory
from repro_torch import configs
from repro_torch.launch import memory

FIELDS = ("params", "grads", "opt", "activations", "kv_cache", "total",
          "persisted")


def _meshes(chips=(1, 8, 64), ep=(1, 2, 4)):
    rows = []
    for c in chips:
        for e in ep:
            for p in (1, 2, 4):
                if c % (e * p):
                    continue
                for t in (1, 2, 4):
                    if c % (e * p * t):
                        continue
                    d = c // (e * p * t)
                    for m in (1, 2, 8):
                        rows.append((d, t, p, e, m))
    return {k: np.array(v) for k, v in zip(("dp", "tp", "pp", "ep",
                                            "microbatches"), zip(*rows))}


def _equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("arch, seq", [
    ("dlrm-mlp", 1), ("smollm-135m", 512), ("qwen2-7b", 4096),
    ("qwen2-moe-a2.7b", 512), ("qwen3-moe-30b-a3b", 2048),
    ("whisper-tiny", 448), ("hymba-1.5b", 2048)])
def test_training_working_set_equals_the_reference(arch, seq):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    mesh = _meshes()
    batch = np.where(mesh["dp"] % 2 == 0, 256.0, 64.0)
    stage = np.array([0, 1, 2, 3])[:, None]
    for remat in (False, True):
        kw = dict(batch=batch, seq=seq, zero_stage=stage, remat=remat,
                  **mesh)
        _equal(memory.training_working_set(cfg, **kw),
               jax_memory.training_working_set(jcfg, **kw))
    one = dict(batch=8, seq=seq)                       # scalars: one mesh
    _equal(memory.training_working_set(cfg, **one),
           jax_memory.training_working_set(jcfg, **one))


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-7b",
                                  "qwen3-moe-30b-a3b", "dlrm-mlp",
                                  "internvl2-26b"])
def test_decode_working_set_equals_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    mesh = _meshes(ep=(1,))
    kw = dict(batch=np.array([8.0, 64.0, 128.0])[:, None], seq=32768,
              dp=mesh["dp"], tp=mesh["tp"], pp=mesh["pp"])
    _equal(memory.decode_working_set(cfg, **kw),
           jax_memory.decode_working_set(jcfg, **kw))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "smollm-135m"])
def test_min_zero_stage_equals_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jax_configs.get_config(arch)
    mesh = _meshes()
    for capacity in (0.0, 16e9, 80e9, 1e15):
        for remat in (False, True):
            kw = dict(batch=256, seq=1024, remat=remat, **mesh)
            got = memory.min_zero_stage(cfg, capacity, **kw)
            np.testing.assert_array_equal(
                got, jax_memory.min_zero_stage(jcfg, capacity, **kw))
            assert got.dtype == np.int64


def test_constants_and_the_one_card_footprints():
    for name in ("PARAM_BYTES", "GRAD_BYTES", "OPT_BYTES",
                 "SERVE_PARAM_BYTES", "KV_BYTES", "ACT_COEFF",
                 "ACT_COEFF_REMAT", "REMAT_FLOPS_FACTOR"):
        assert getattr(memory, name) == getattr(jax_memory, name), name
    # qwen3-moe's fp32 params alone pass an 80 GB card; smollm at (8, 512)
    # holds 16 B a param + its saved activations
    q3 = memory.training_working_set(
        configs.get_config("qwen3-moe-30b-a3b"), batch=8, seq=512)
    assert float(q3.params) > 120e9 and float(q3.total) > 80e9
    sm = memory.training_working_set(configs.get_config("smollm-135m"),
                                     batch=8, seq=512)
    assert float(sm.params + sm.grads + sm.opt) == 16.0 * 134515008.0
    assert float(sm.activations) == 2.0 * 30 * 8 * 512 * 576 * 2.0
