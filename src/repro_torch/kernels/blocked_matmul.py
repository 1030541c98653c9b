"""Fused ``act(A·B + bias)``: the wrapper of ``csrc/blocked_matmul.cu``.

The CUDA kernel replaces ``src/repro/kernels/blocked_matmul.py::
blocked_matmul`` (the Pallas TPU kernel); the source's header says what
bounds it on an H100 and what its design does about that.  This wrapper
checks its inputs, allocates the output, launches on the current stream and
counts launches.  A tensor on the CPU takes the plain version,
``ref.ref_matmul``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTS, ref_matmul

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {None: 0, **{name: i + 1 for i, name in enumerate(ACTS)}}
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _launcher():
    fn = _build.load("blocked_matmul").blocked_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
           act: Optional[str]) -> None:
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


def blocked_matmul(a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   act: Optional[str] = None) -> torch.Tensor:
    """a (M, K) @ b (K, N) [+ bias (N,)], activation, in ``a.dtype``.

    fp32 accumulation; the bias is added and ``act`` (None, relu, relu2,
    silu, gelu-tanh) applied in fp32 before one cast.  Any M, N, K >= 1.
    """
    _check(a, b, bias, act)
    if a.device.type == "cpu":
        return ref_matmul(a, b, bias=bias, act=act)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    launch = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(a.data_ptr(), b.data_ptr(),
                    None if bias is None else bias.data_ptr(),
                    out.data_ptr(), M, N, K, _DTYPE_CODE[a.dtype],
                    _ACT_CODE[act], stream)
    if rc != 0:
        raise RuntimeError(f"blocked_matmul kernel launch failed: CUDA error "
                           f"{rc} at M={M} N={N} K={K} {a.dtype}")
    blocked_matmul.launches += 1
    return out


#: kernel launches so far in this process (CPU calls do not count)
blocked_matmul.launches = 0
