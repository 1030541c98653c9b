"""The port's blocked matmul on the CPU against the JAX package's kernel.

The same numpy arrays go to JAX's Pallas ``blocked_matmul`` (interpret mode,
as ``tests/test_kernels.py`` runs it) and reference, and to the port's
wrapper, which on a CPU tensor runs its plain version ``ref_matmul``.
Tolerances are ``tests/test_kernels.py``'s: rel error (max abs diff over
max |want|) < 1e-5 in fp32, < 2e-2 in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.blocked_matmul import blocked_matmul as jax_blocked_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels.blocked_matmul import blocked_matmul

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = np.maximum(np.max(np.abs(want)), 1e-6)
    return float(np.max(np.abs(got - want))) / denom


def _np(x):
    """A JAX or torch array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pair(x, dtype):
    """The same fp32 numpy values as a JAX and a torch array of ``dtype``
    (both round fp32 -> bf16 to nearest even, so the inputs are equal)."""
    return (jnp.asarray(x).astype(JNP[dtype]),
            torch.from_numpy(x).to(TORCH[dtype]))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(512, 512, 512), (1024, 512, 512),
                                 (512, 1024, 1536)])
def test_shapes_dtypes_match_pallas_and_reference(dtype, mkn):
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N)
    ja, ta = _pair(_normal(rng, (M, K)), dtype)
    jb, tb = _pair(_normal(rng, (K, N)), dtype)
    got = blocked_matmul(ta, tb)
    assert got.dtype == TORCH[dtype] and got.shape == (M, N)
    assert _rel_err(_np(got), _np(jax_blocked_matmul(ja, jb, interpret=True))) \
        < TOL[dtype]
    assert _rel_err(_np(got), _np(jax_ref.ref_matmul(ja, jb))) < TOL[dtype]


@pytest.mark.parametrize("act", [None, "relu", "relu2", "silu", "gelu"])
def test_fused_epilogue_matches_pallas(act):
    rng = np.random.default_rng(3)
    a, b, bias = (_normal(rng, (512, 512)), _normal(rng, (512, 512)),
                  _normal(rng, (512,)))
    want = jax_blocked_matmul(jnp.asarray(a), jnp.asarray(b),
                              bias=jnp.asarray(bias), act=act, interpret=True)
    got = blocked_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         bias=torch.from_numpy(bias), act=act)
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_bf16_bias_without_activation_matches_reference():
    rng = np.random.default_rng(4)
    (ja, ta), (jb, tb), (jbias, tbias) = (
        _pair(_normal(rng, s), "bfloat16") for s in ((256, 384), (384, 128),
                                                     (128,)))
    got = blocked_matmul(ta, tb, bias=tbias)
    want = jax_ref.ref_matmul(ja, jb, bias=jbias)
    assert _rel_err(_np(got), _np(want)) < TOL["bfloat16"]


def test_gelu_is_the_tanh_form():
    # pre-activations of |y| ~ 1-3, where tanh and erf gelu differ by ~1e-3
    rng = np.random.default_rng(5)
    a = _normal(rng, (64, 64), 0.25)
    b = _normal(rng, (64, 128))
    bias = _normal(rng, (128,))
    want = _np(jax_blocked_matmul(jnp.asarray(a), jnp.asarray(b),
                                  bias=jnp.asarray(bias), act="gelu",
                                  interpret=True))
    ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
    got = blocked_matmul(ta, tb, bias=tbias, act="gelu")
    assert _rel_err(_np(got), want) < 1e-5
    erf = F.gelu(ta @ tb + tbias)                  # torch's default form
    assert _rel_err(_np(erf), want) > 1e-5


def test_ops_pads_nothing_on_odd_shapes():
    rng = np.random.default_rng(6)
    a, b = _normal(rng, (300, 700)), _normal(rng, (700, 520))
    want = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b), act="gelu")
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), act="gelu")
    assert got.shape == (300, 520)
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_ops_leading_dims():
    rng = np.random.default_rng(7)
    a, b = _normal(rng, (4, 128, 512)), _normal(rng, (512, 512))
    bias = _normal(rng, (512,))
    want = jax_ops.matmul(jnp.asarray(a), jnp.asarray(b),
                          bias=jnp.asarray(bias), act="relu")
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     bias=torch.from_numpy(bias), act="relu")
    assert got.shape == (4, 128, 512)
    assert _rel_err(_np(got), _np(want)) < 1e-5


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(_normal(rng, s)) for s in ((33, 17), (17, 9)))
    before = blocked_matmul.launches
    got = ops.matmul(a, b, act="silu")
    assert torch.equal(got, ref.ref_matmul(a, b, act="silu"))
    assert blocked_matmul.launches == before


@pytest.mark.parametrize("case", [
    "act", "rank", "inner", "dtype_mix", "dtype_f16", "strided", "bias_shape",
    "bias_dtype", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a, b = torch.ones((4, 8)), torch.ones((8, 6))
    bias, act = None, "relu"
    if case == "act":
        act = "tanh"
    elif case == "rank":
        a = torch.ones((2, 4, 8))
    elif case == "inner":
        b = torch.ones((7, 6))
    elif case == "dtype_mix":
        b = b.to(torch.bfloat16)
    elif case == "dtype_f16":
        a, b = a.half(), b.half()
    elif case == "strided":
        b = torch.ones((6, 8)).t()
    elif case == "bias_shape":
        bias = torch.ones((5,))
    elif case == "bias_dtype":
        bias = torch.ones((6,), dtype=torch.float64)
    elif case == "empty":
        a, b = torch.ones((0, 8)), torch.ones((8, 6))
    with pytest.raises((ValueError, TypeError)):
        blocked_matmul(a, b, bias=bias, act=act)


def test_ref_rejects_unknown_activation():
    with pytest.raises(ValueError, match="unsupported activation"):
        ref.ref_matmul(torch.ones((2, 2)), torch.ones((2, 2)), act="tanh")


@pytest.mark.parametrize("case", [
    # (M, N, K, dtype, aligned) -> kernel
    ((256, 4096, 4096, torch.bfloat16, True), "sm90"),
    ((16384, 1536, 576, torch.bfloat16, True), "sm90"),
    ((16384, 576, 1536, torch.bfloat16, True), "sm90"),
    ((1, 8, 8, torch.bfloat16, True), "sm90"),
    ((300, 520, 700, torch.bfloat16, True), "wmma"),     # K % 8 != 0
    ((1, 17, 4100, torch.bfloat16, True), "wmma"),       # N % 8 != 0
    ((256, 4096, 4096, torch.bfloat16, False), "wmma"),  # a base off 16 B
    ((256, 4096, 4096, torch.float32, True), "f32"),
    ((300, 520, 700, torch.float32, False), "f32_edge"),  # a base off 16 B
    ((300, 520, 700, torch.float32, True), "f32"),        # K % 4 == 0
    ((1, 17, 4100, torch.float32, True), "f32_edge"),     # N % 4 != 0
    ((300, 520, 702, torch.float32, True), "f32_edge"),   # K % 4 != 0
    ((300, 8, 64, torch.float32, True), "f32"),           # N below a tile
    ((130, 520, 8, torch.float32, True), "f32"),          # K below a stage
], ids=lambda c: "-".join(map(str, c[0])).replace("torch.", "")
   if isinstance(c[0], tuple) else str(c))
def test_variant_rule(case):
    from repro_torch.kernels.blocked_matmul import variant
    (M, N, K, dtype, aligned), want = case
    assert variant(M, N, K, dtype, aligned) == want


@pytest.mark.parametrize("case", [
    # (M, K, N) on 132 SMs -> (BN, n_fastest): the six main-path shapes,
    # then edges; the N tile runs fastest when M >= N
    ((256, 4096, 4096), (64, False)),     # 32 tiles of 256 -> 128 of 64
    ((1024, 4096, 4096), (256, False)),
    ((4096, 4096, 4096), (256, True)),
    ((16384, 576, 1536), (256, True)),    # FFN gate and up
    ((16384, 1536, 576), (192, True)),    # FFN down: 3 tiles of 192
    ((1, 4096, 8), (64, False)),
    ((1000, 1536, 576), (64, True)),      # 24 tiles of 192 -> 72 of 64
    ((3000, 1024, 1000), (256, True)),    # 256 and 128 both pad to 1024
    ((5000, 512, 2048), (256, True)),
], ids=lambda c: "x".join(map(str, c[0])) if isinstance(c[0], tuple) else "")
def test_tile_plan_rule(case):
    from repro_torch.kernels.blocked_matmul import SM90_BN, Plan, tile_plan
    (M, K, N), want = case
    plan = tile_plan(M, N, K, num_sms=132)
    assert plan == Plan(*want)
    assert plan.bn in SM90_BN


@pytest.mark.parametrize("case", [
    # byte offsets of (A, B, bias) from 64-byte aligned bases -> sm90's rule
    ((0, 0, None), True),
    ((0, 0, 0), True),
    ((16, 32, 4), True),       # a bias at a 4-byte offset: read in pairs
    ((0, 0, 2), False),
    ((2, 0, None), False),     # TMA needs 16-byte bases for A and B
    ((0, 8, 0), False),
], ids=str)
def test_aligned_rule(case):
    from repro_torch.kernels.blocked_matmul import aligned
    offsets, want = case
    base = torch.zeros(4096, dtype=torch.bfloat16)
    assert base.data_ptr() % 64 == 0
    a, b, bias = (None if off is None else base[off // 2:off // 2 + 64]
                  for off in offsets)
    assert aligned(a, b, bias) is want


@pytest.mark.parametrize("case", [
    # (M, K, N) on 132 SMs -> f32 tile (BM, BN): the calibration sizes
    # (64x128 from 768^3 up, where its grid covers half the SMs), then
    # ragged shapes
    ((64, 64, 64), (32, 64)), ((128, 128, 128), (32, 64)),
    ((256, 256, 256), (32, 64)), ((512, 512, 512), (32, 64)),
    ((768, 768, 768), (64, 128)), ((1024, 1024, 1024), (64, 128)),
    ((2048, 2048, 2048), (64, 128)), ((4096, 4096, 4096), (64, 128)),
    ((300, 700, 520), (32, 64)),          # 45 tiles of 64x128
    ((1000, 1536, 576), (64, 128)),       # 80 tiles of 64x128
    ((1, 4096, 4096), (32, 64)),
    ((300, 64, 8), (32, 64)),
    ((1000, 4096, 3000), (64, 128)),
    ((4100, 100, 4), (32, 64)),           # 65 tiles of 64x128: under half
    ((4200, 100, 4), (64, 128)),          # 66: half
], ids=lambda c: "x".join(map(str, c[0])) if isinstance(c[0], tuple) else "")
def test_f32_plan_rule(case):
    from repro_torch.kernels.blocked_matmul import F32_TILES, f32_plan
    (M, K, N), want = case
    tile = f32_plan(M, N, K, num_sms=132)
    assert (tile.bm, tile.bn) == want and tile in F32_TILES

    def grid(bm, bn):
        return -(-M // bm) * -(-N // bn)
    # never fewer CTAs than f32_edge's 128 x 128 tiles
    assert grid(tile.bm, tile.bn) >= grid(128, 128)
    # whole warps of 4·tm rows x 64 columns (RingCfg in the source), 128
    # threads: 255 registers each fit the SM's 65,536
    assert tile.bm % (4 * tile.tm) == 0 and tile.bn % 64 == 0
    threads = 32 * (tile.bm // (4 * tile.tm)) * (tile.bn // 64)
    assert threads == 128 and threads * 255 <= 65536
    # the ring: 4 stages of A (bm rows of 16 + 4 pad floats) and B (16 rows
    # of bn floats) in 227 KB; live floats a thread in the inner loop (tm x 8
    # accumulators, a float4 of A a row, two of B) within 128 registers
    assert 4 * 4 * (tile.bm * 20 + 16 * tile.bn) <= 232448
    assert 8 * tile.tm + 4 * tile.tm + 8 <= 128


def test_f32_plan_fills_half_the_sms_where_it_can():
    from repro_torch.kernels.blocked_matmul import F32_TILES, f32_plan
    big, small = F32_TILES
    for sms in (66, 114, 132):
        for s in (64, 256, 600, 768, 1000, 4096):
            tile = f32_plan(s, s, s, num_sms=sms)
            assert tile == (big if 2 * (-(-s // 64) * -(-s // 128)) >= sms
                            else small)


def test_cpu_calls_count_no_launch_by_variant():
    rng = np.random.default_rng(9)
    a, b = (torch.from_numpy(_normal(rng, s)).to(torch.bfloat16)
            for s in ((64, 64), (64, 128)))
    before = dict(blocked_matmul.launches_by_variant)
    assert set(before) == {"sm90", "wmma", "f32", "f32_edge"}
    blocked_matmul(a, b, act="relu")
    blocked_matmul(a.float(), b.float())
    blocked_matmul(a.float(), b.float()[:, :17].contiguous())  # f32_edge's
    assert blocked_matmul.launches_by_variant == before


def test_build_key_covers_headers_and_flags(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "k.cuh").write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("k") not in (first, second)
