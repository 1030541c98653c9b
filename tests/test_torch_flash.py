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


@pytest.mark.parametrize("case", [
    # (dtype, dh, TMA can read the tensors) -> kernel
    ((torch.bfloat16, 64, True), "sm90"),
    ((torch.bfloat16, 128, True), "sm90"),
    ((torch.bfloat16, 64, False), "mma"),
    ((torch.bfloat16, 128, False), "mma"),
    ((torch.float32, 64, True), "f32"),
    ((torch.float32, 128, False), "f32"),
], ids=lambda c: "-".join(map(str, c[0])).replace("torch.", "")
   if isinstance(c[0], tuple) else str(c))
def test_variant_rule(case):
    from repro_torch.kernels.flash_attention import VARIANTS, variant
    (dtype, dh, readable), want = case
    assert variant(dtype, dh, readable) == want
    assert want in VARIANTS


@pytest.mark.parametrize("case", ["bhsd", "model_layout", "broadcast_kv",
                                  "size_one_stride_zero"])
def test_tma_readable_rule(case):
    from repro_torch.kernels.flash_attention import tma_readable
    if case == "bhsd":
        x, want = torch.zeros((2, 3, 40, 64)), True
    elif case == "model_layout":     # (B, S, H, dh) seen through a transpose
        x, want = torch.zeros((2, 40, 3, 64)).transpose(1, 2), True
    elif case == "broadcast_kv":     # one kv head expanded: stride 0 on 3
        x, want = torch.zeros((2, 1, 40, 64)).expand(2, 3, 40, 64), False
    else:                            # never stepped over: any stride will do
        x, want = torch.zeros((2, 1, 40, 64)).expand(2, 1, 40, 64), True
        x = x.as_strided(x.shape, (x.stride(0), 0, 64, 1))
    assert tma_readable(x) is want


def test_cpu_calls_count_no_launch_by_variant():
    before = dict(flash_attention_bhsd.launches_by_variant)
    assert set(before) == {"sm90", "mma", "f32"}
    for dtype in ("float32", "bfloat16"):
        _, (q, k, v) = _qkv(4, 1, 70, 4, 2, 64, dtype)
        ops.flash_attention(q, k, v, causal=True)
    assert flash_attention_bhsd.launches_by_variant == before


def test_bind_types_both_launchers():
    """The ctypes signatures match the C prototypes: 64-bit pointers (q, k,
    v, o, strides and the stream) and C ints, a float scale, and the dtype
    code on the base launcher only."""
    import ctypes
    import types

    from repro_torch.kernels.flash_attention import bind

    lib = types.SimpleNamespace(
        flash_attention_launch=types.SimpleNamespace(),
        flash_attention_sm90_launch=types.SimpleNamespace())
    base, sm90 = bind(lib)
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
    assert base.argtypes == head + [ctypes.c_int, ctypes.c_void_p]
    assert sm90.argtypes == head + [ctypes.c_void_p]
    assert base.restype is sm90.restype is ctypes.c_int


def _mutant_copies():
    import chip_mutants
    return [(src, name, edits) for table in (chip_mutants.MUTANTS,
                                             chip_mutants.ALTERNATIVES)
            for src, copies in table.items()
            for name, edits in copies.items()]


@pytest.mark.parametrize("copy", _mutant_copies(),
                         ids=[f"{src}-{name}" for src, name, _
                              in _mutant_copies()])
def test_chip_mutants_edit_text_the_kernel_source_holds_once(copy):
    """Every planted fault and design alternative of ``chip_mutants.py``
    edits text that its kernel source holds exactly once, so the copies it
    builds on the card differ from the real kernel where they say."""
    from repro_torch.kernels import _build
    src, _, edits = copy
    text = (_build.CSRC / f"{src}.cu").read_text()
    assert [text.count(old) for old, _ in edits] == [1] * len(edits)
