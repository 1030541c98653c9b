"""The port's data pipeline against ``repro.data.pipeline``.

Every family's ``batch(step)`` is the reference's byte for byte: the same
keys, dtypes (int32 tokens and labels, float32 frames, patches, features
and click), shapes and bytes, at several steps and for the second host of
two.  ``to_device`` widens the index arrays to int64 and changes no value.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.data import pipeline as jax_pipeline
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline

ARCHS = ("smollm-135m", "whisper-tiny", "internvl2-26b", "dlrm-mlp")
HOSTS = [dict(n_hosts=1, host_id=0), dict(n_hosts=2, host_id=1)]


def _streams(arch, **data):
    cfg = dict(seed=5, global_batch=4, seq_len=12, **data)
    return (jax_pipeline.make_stream(jax_get_reduced(arch),
                                     jax_pipeline.DataConfig(**cfg)),
            pipeline.make_stream(get_reduced(arch),
                                 pipeline.DataConfig(**cfg)))


@pytest.mark.parametrize("hosts", HOSTS, ids=["host0of1", "host1of2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_are_the_reference_byte_for_byte(arch, hosts):
    want_stream, got_stream = _streams(arch, **hosts)
    assert type(got_stream).__name__ == type(want_stream).__name__
    for step in (0, 1, 7, 1000):
        want, got = want_stream.batch(step), got_stream.batch(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (k, step)
    assert got_stream.batch(0)[next(iter(want))].shape[0] == \
        4 // hosts["n_hosts"]


def test_hosts_draw_different_shards():
    _, one = _streams("smollm-135m", n_hosts=2, host_id=0)
    _, two = _streams("smollm-135m", n_hosts=2, host_id=1)
    assert not np.array_equal(one.batch(3)["tokens"], two.batch(3)["tokens"])


def test_iteration_and_skip_to_follow_the_step():
    _, stream = _streams("smollm-135m")
    it = iter(stream)
    for step in range(3):
        assert np.array_equal(next(it)["tokens"], stream.batch(step)["tokens"])
    assert pipeline.skip_to(stream, 10) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_to_device_widens_indices_and_keeps_values(arch):
    _, stream = _streams(arch)
    batch = stream.batch(2)
    moved = pipeline.to_device(batch, "cpu")
    assert list(moved) == list(batch)
    for k, v in batch.items():
        t = moved[k]
        assert t.device.type == "cpu"
        assert t.dtype == (torch.int64 if v.dtype == np.int32
                           else torch.float32), k
        assert np.array_equal(t.numpy(), v), k
