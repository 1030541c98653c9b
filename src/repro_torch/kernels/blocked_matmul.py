"""Fused ``act(A·B + bias)``: the wrapper of ``csrc/blocked_matmul.cu``.

The CUDA kernels replace ``src/repro/kernels/blocked_matmul.py::
blocked_matmul`` (the Pallas TPU kernel); the source's header says what
bounds them on an H100 and what their design does about that.  This wrapper
checks its inputs, picks the kernel (``variant``) and, for the sm90 and f32
kernels, their tiles (``tile_plan``, ``f32_plan``), allocates the output,
launches on the current stream and counts launches, in total and by
variant.  A tensor on the CPU takes the plain version, ``ref.ref_matmul``; a
CUDA tensor launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTS, ref_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {None: 0, **{name: i + 1 for i, name in enumerate(ACTS)}}
_INT_MAX = 2 ** 31 - 1

#: the kernels, in ``variant``'s words: the Hopper TMA + wgmma kernel, the
#: wmma kernel for bf16 shapes TMA cannot read, IEEE fp32 on the CUDA cores
#: through a cp.async ring, and the first fp32 design for fp32 calls a
#: 16-byte copy cannot read
VARIANTS = ("sm90", "wmma", "f32", "f32_edge")
#: the sm90 kernel's tile rows (two consumer warpgroups of 64) and the tile
#: widths it is compiled for
SM90_BM = 128
SM90_BN = (64, 128, 192, 256)


class Plan(NamedTuple):
    """How the sm90 kernel covers one product; the launcher adds the grid
    (one CTA per tile, at most one per SM)."""

    bn: int            # tile width
    n_fastest: bool    # tile order: the N tile fastest, else the M tile


class F32Tile(NamedTuple):
    """One tile the f32 kernel is compiled for (``RingCfg`` in the source):
    BM x BN outputs, ``tm`` rows x 8 columns a thread, warps of 4·tm x 64;
    128 threads either way."""

    bm: int
    bn: int
    tm: int


#: the f32 kernel's two tiles, the larger first
F32_TILES = (F32Tile(64, 128, 8), F32Tile(32, 64, 2))


class Launchers(NamedTuple):
    """The typed entry points of a library built from
    ``csrc/blocked_matmul.cu`` (or an edited copy)."""

    base: Callable[..., int]   # f32_edge (dtype 0) and wmma (dtype 1)
    sm90: Callable[..., int]
    f32: Callable[..., int]


def bind(lib: ctypes.CDLL) -> Launchers:
    """``blocked_matmul_launch``, ``blocked_matmul_sm90_launch`` and
    ``blocked_matmul_f32_launch`` of ``lib``, typed."""
    base = lib.blocked_matmul_launch
    base.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sm90 = lib.blocked_matmul_sm90_launch
    sm90.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    f32 = lib.blocked_matmul_f32_launch
    f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (base, sm90, f32):
        fn.restype = ctypes.c_int
    return Launchers(base, sm90, f32)


@functools.cache
def _launcher():
    return bind(_build.load("blocked_matmul"))


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned(a: torch.Tensor, b: torch.Tensor,
            bias: Optional[torch.Tensor]) -> bool:
    """Whether the bases meet the rules of the sm90 and f32 kernels: A and B
    16-byte aligned (TMA, 16-byte cp.async), the bias 4-byte aligned (sm90
    reads it in bf16 pairs at even columns; f32 one float at a time, which
    any fp32 tensor meets).  The output is the wrapper's own allocation,
    aligned to far more."""
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and (bias is None or bias.data_ptr() % 4 == 0))


def variant(M: int, N: int, K: int, dtype: torch.dtype,
            is_aligned: bool) -> str:
    """The kernel that takes a call, by dtype, shape and alignment alone.

    sm90 reads A and B through TMA, f32 through 16-byte cp.async copies;
    both need 16-byte row strides (K and N multiples of 8 bf16 or 4 fp32
    values) and bases as ``aligned`` says (``is_aligned``).  Other bf16
    calls go to wmma, other fp32 calls to f32_edge.
    """
    if dtype == torch.float32:
        return "f32" if K % 4 == 0 and N % 4 == 0 and is_aligned \
            else "f32_edge"
    if K % 8 == 0 and N % 8 == 0 and is_aligned:
        return "sm90"
    return "wmma"


@functools.lru_cache(maxsize=1024)
def tile_plan(M: int, N: int, K: int, num_sms: int) -> Plan:
    """The sm90 kernel's tiles for an (M, K) @ (K, N) product.

    1. The width of {256, 192, 128} whose tiles pad N least, the widest on a
       tie: N = 576 takes 192 (3 tiles, where 128 needs 4.5), N = 1536 and
       4096 take 256.
    2. While the 128-row tiles fill at most half the SMs, halve the width
       (192 goes to 64), down to 64: (256, 4096, 4096) goes from 32 tiles of
       256 to 128 of 64.
    3. The order shares the larger operand in L2: the N tile runs fastest
       when A is at least as large as B (M >= N), so the CTAs in flight
       share a band of A's rows ((16384, 1536, 576) reads its 50 MB A from
       HBM once, not once per N tile); otherwise the M tile runs fastest and
       they share a band of B's columns.
    ``chip_smoke.py`` times the other widths and orders at every main-path
    shape; PERF.md has the numbers behind each step.
    """
    m_tiles = -(-M // SM90_BM)
    bn = min((256, 192, 128), key=lambda w: (-(-N // w) * w, -w))
    while bn > 64 and 2 * m_tiles * -(-N // bn) <= num_sms:
        bn = 64 if bn == 192 else bn // 2
    return Plan(bn, M >= N)


@functools.lru_cache(maxsize=1024)
def f32_plan(M: int, N: int, K: int, num_sms: int) -> F32Tile:
    """The f32 kernel's tile for an (M, K) @ (K, N) product: 64x128 where
    its grid (one CTA per tile, 2-3 share an SM) covers at least half the
    SMs, else 32x64, which has 4x the CTAs and a quarter of the work a
    thread.  On 132 SMs the square calibration products take 64x128 from
    768^3 (72 CTAs) up and 32x64 at 512^3 (128 CTAs) and below.  K does not
    enter: every tile runs the whole of K.  ``chip_smoke.py``'s
    ``f32_options`` times both tiles at every calibration size.
    """
    big, small = F32_TILES
    return big if 2 * -(-M // big.bm) * -(-N // big.bn) >= num_sms else small


def _check(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
           act: Optional[str]) -> None:
    _build.refuse_dtensor(a=a, b=b, bias=bias)
    if act not in _ACT_CODE:
        raise ValueError(f"unsupported activation {act!r}; have {ACTS}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"need 2-D a and b, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    (M, K), (K2, N) = a.shape, b.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX:
        raise ValueError(f"dims must lie in [1, 2^31): M={M} N={N} K={K}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"need a and b both float32 or both bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous row-major")
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if bias is not None:
        if bias.shape != (N,) or bias.dtype != a.dtype \
                or bias.device != a.device or not bias.is_contiguous():
            raise ValueError(
                f"bias must be a contiguous ({N},) {a.dtype} tensor on "
                f"{a.device}, got {tuple(bias.shape)} {bias.dtype} on "
                f"{bias.device}")


def refuse_autograd(name: str, *xs: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record a call: the kernels write a fresh
    tensor through ctypes, so their output has no ``grad_fn`` and a
    gradient would stop there without a word."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name}: the CUDA kernels are forward-only (no backward, as the "
            f"JAX package's Pallas kernels have none); call it under "
            f"torch.no_grad() or on the plain path (a CPU tensor, or "
            f"use_kernel_matmul / use_flash off)")


def _launch(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            act: Optional[str], kind: str) -> torch.Tensor:
    """Launch the ``kind`` kernel (sm90 with ``tile_plan``'s tiles, f32 with
    ``f32_plan``'s) on CUDA tensors that passed ``_check``; count it."""
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fns = _launcher()
    ptrs = (a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    plan = None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "sm90":
            plan = tile_plan(M, N, K, _num_sms(a.device.index))
            rc = fns.sm90(*ptrs, M, N, K, _ACT_CODE[act], plan.bn,
                          int(plan.n_fastest), stream)
        elif kind == "f32":
            plan = f32_plan(M, N, K, _num_sms(a.device.index))
            rc = fns.f32(*ptrs, M, N, K, _ACT_CODE[act], plan.bm, plan.bn,
                         stream)
        else:
            rc = fns.base(*ptrs, M, N, K, _DTYPE_CODE[a.dtype],
                          _ACT_CODE[act], stream)
    if rc != 0:
        raise RuntimeError(f"blocked_matmul {kind} kernel launch failed: "
                           f"CUDA error {rc} at M={M} N={N} K={K} {a.dtype}"
                           + (f" {plan}" if plan else ""))
    blocked_matmul.launches += 1
    blocked_matmul.launches_by_variant[kind] += 1
    return out


def blocked_matmul(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) [+ bias (N,)], activation, in ``a.dtype``.

    fp32 accumulation; the bias is added and ``act`` (None, relu, relu2,
    silu, gelu-tanh) applied in fp32 before one cast.  Any M, N, K >= 1.
    Forward only: a CUDA input that requires grad while grad mode is on
    raises (the CPU's plain version stays differentiable).
    """
    _check(a, b, bias, act)
    if a.device.type == "cpu":
        return ref_matmul(a, b, bias=bias, act=act)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    refuse_autograd("blocked_matmul", a, b, bias)
    (M, K), N = a.shape, b.shape[1]
    return _launch(a, b, bias, act,
                   variant(M, N, K, a.dtype, aligned(a, b, bias)))


#: kernel launches so far in this process (CPU calls do not count), in total
#: and by ``variant``
blocked_matmul.launches = 0
blocked_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
