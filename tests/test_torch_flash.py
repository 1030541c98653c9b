"""The port's flash attention on the CPU against the JAX package's.

The same numpy arrays go to JAX's oracle ``ref.ref_flash_attention``, to
its Pallas ``flash_attention_bhsd`` run as ``tests/test_kernels.py`` runs it
(interpret mode), and to the port, whose wrapper on a CPU tensor runs its
plain version ``ref_flash_attention``.  Tolerances are
``tests/test_kernels.py``'s: rel error (max abs diff over max |want|)
< 1e-4 in fp32, < 3e-2 in bf16 (the kernel rounds p to bf16 before P.V,
the oracle does not).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import (
    flash_attention_bhsd as jax_flash_bhsd)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = np.maximum(np.max(np.abs(want)), 1e-6)
    return float(np.max(np.abs(got - want))) / denom


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(seed, B, S, H, K, dh, dtype):
    """(jax q, k, v), (torch q, k, v) from the same numpy values, in the
    model layout (B, S, heads, dh)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh))]
    return ([jnp.asarray(a).astype(JNP[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs])


ORACLE_CASES = [
    dict(B=2, S=128, H=4, K=2, dh=32, causal=True, window=0),     # G = 2
    dict(B=1, S=96, H=3, K=3, dh=64, causal=True, window=0),      # G = 1
    dict(B=1, S=160, H=6, K=2, dh=16, causal=True, window=40),    # G = 3
    dict(B=2, S=64, H=6, K=2, dh=32, causal=False, window=0),
    dict(B=1, S=100, H=4, K=4, dh=32, causal=False, window=17),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ORACLE_CASES,
                         ids=lambda c: "B{B}S{S}H{H}K{K}d{dh}c{causal:d}w{window}"
                         .format(**c))
def test_ref_matches_jax_oracle(case, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(7, case["B"], case["S"], case["H"],
                                      case["K"], case["dh"], dtype)
    kw = dict(causal=case["causal"], window=case["window"])
    got = ref.ref_flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TORCH[dtype] and got.shape == tq.shape
    assert _rel_err(_np(got), _np(jax_ref.ref_flash_attention(jq, jk, jv, **kw))) \
        < TOL[dtype]


PALLAS_CASES = [
    dict(H=4, K=2, causal=True, window=0),     # G = 2
    dict(H=3, K=3, causal=False, window=0),    # G = 1
    dict(H=6, K=2, causal=True, window=100),   # G = 3
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=lambda c: "H{H}K{K}c{causal:d}w{window}".format(**c))
def test_wrapper_matches_pallas_kernel_with_seq_len(case, dtype):
    """S = 300 keys padded to 384 (three 128-blocks): keys at or past
    seq_len = 300 hold finite junk that both versions must mask."""
    B, Sp, dh = 1, 384, 32
    (jq, jk, jv), (tq, tk, tv) = _qkv(11, B, Sp, case["H"], case["K"], dh,
                                      dtype)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    want = jax_flash_bhsd(sw(jq), sw(jk), sw(jv), causal=case["causal"],
                          window=case["window"], seq_len=300, block_q=128,
                          block_k=128, interpret=True)
    got = flash_attention_bhsd(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), causal=case["causal"],
                               window=case["window"], seq_len=300)
    assert got.shape == (B, case["H"], Sp, dh) and got.dtype == TORCH[dtype]
    assert _rel_err(_np(got), _np(want)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ragged_seq_matches_jax_ops(dtype):
    """S = 300: JAX pads to 512 and runs its Pallas kernel; the port pads
    nothing."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 300, 6, 2, 32, dtype)
    want = jax_ops.flash_attention(jq, jk, jv, causal=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (1, 300, 6, 32)
    assert _rel_err(_np(got), _np(want)) < TOL[dtype]


def test_cpu_calls_take_the_plain_version_at_any_dh_and_count_no_launch():
    before = flash_attention_bhsd.launches
    for dh in (8, 48, 64):
        _, (q, k, v) = _qkv(dh, 2, 33, 4, 2, dh, "float32")
        got = ops.flash_attention(q, k, v, causal=True, window=5)
        assert torch.equal(got, ref.ref_flash_attention(q, k, v, causal=True,
                                                        window=5))
    assert flash_attention_bhsd.launches == before


def test_rows_that_see_no_key_are_zero_not_nan():
    # non-causal, window 4, seq_len 10: rows >= 13 see no key below 10
    _, (q, k, v) = _qkv(5, 1, 20, 2, 1, 16, "float32")
    got = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=False, window=4,
                               seq_len=10)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :, 13:], torch.zeros_like(got[:, :, 13:]))
    assert got[:, :, :13].abs().max() > 0


@pytest.mark.parametrize("case", [
    "rank", "kv_shape", "heads", "dtype_mix", "dtype_f16", "window",
    "seq_len"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v = torch.ones((1, 4, 8, 16)), torch.ones((1, 2, 8, 16)), \
        torch.ones((1, 2, 8, 16))
    kw = {}
    if case == "rank":
        q = torch.ones((4, 8, 16))
    elif case == "kv_shape":
        v = torch.ones((1, 2, 7, 16))
    elif case == "heads":
        k, v = torch.ones((1, 3, 8, 16)), torch.ones((1, 3, 8, 16))
    elif case == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif case == "dtype_f16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "window":
        kw["window"] = -1
    elif case == "seq_len":
        kw["seq_len"] = -2
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bhsd(q, k, v, **kw)
