"""Causal GQA flash attention: the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces ``src/repro/kernels/flash_attention.py::
flash_attention_bhsd`` (the Pallas TPU kernel); the source's header says
what bounds it on an H100 and what its design does about that.  This
wrapper keeps the JAX layout and meaning, checks its inputs, allocates the
output, launches on the current stream and counts launches.  A tensor on
the CPU takes the plain version, ``ref.ref_flash_attention``, at any head
dim; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (smollm's 64; 128 for the 7B/8B
#: configs and the JAX package's tests)
HEAD_DIMS = (64, 128)
_GRID_MAX = 65535   # gridDim.y (heads) and gridDim.z (batch)
_INT_MAX = 2 ** 31 - 1


def bind(lib: ctypes.CDLL):
    """The typed ``flash_attention_launch`` of a library built from
    ``csrc/flash_attention.cu`` (or from an edited copy of it)."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(_build.load("flash_attention"))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           seq_len: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need 4-D (B, heads, S, dh) q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, dh):
        raise ValueError(f"k and v must be (B={B}, K, S={S}, dh={dh}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    K = k.shape[1]
    if min(B, H, K, S, dh) < 1 or H % K:
        raise ValueError(f"need B, S, dh >= 1 and H = G * K query heads, got "
                         f"B={B} H={H} K={K} S={S} dh={dh}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"need q, k, v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if window < 0 or (seq_len is not None and seq_len < 0):
        raise ValueError(f"window and seq_len must be >= 0, got {window} "
                         f"and {seq_len}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes beyond ``_check``: its head dims, and rows it
    can read as 16-byte vectors (innermost stride 1, the other strides and
    the base 16-byte aligned)."""
    B, H, S, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes dh in {HEAD_DIMS}, got {dh}")
    if B > _GRID_MAX or H > _GRID_MAX or S > _INT_MAX:
        raise ValueError(f"B={B}, H={H} must be <= {_GRID_MAX} and "
                         f"S={S} < 2^31")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the kernel reads rows of dh as 16-byte vectors; "
                f"need stride 1 on dh, the other strides multiples of {vec} "
                f"elements and a 16-byte aligned base, got strides "
                f"{x.stride()}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0,
                         seq_len: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,dh), k/v (B,K,S,dh) -> (B,H,S,dh) in ``q.dtype``.

    Query head h reads kv head h // (H // K).  ``seq_len`` (default S)
    masks keys at or past it; ``window`` > 0 masks keys at or before
    ``qpos - window``.  fp32 softmax state; scores scaled by 1/sqrt(dh) in
    fp32.  Any S >= 1, no padding; the CUDA kernel takes dh 64 or 128 and
    any strides that keep dh contiguous, so transposed views of the model
    layout (B,S,H,dh) are read in place.  The output has ``q``'s strides.
    """
    _check(q, k, v, window, seq_len)
    B, H, S, dh = q.shape
    seq_len = S if seq_len is None else min(seq_len, S)
    if q.device.type == "cpu":
        out = ref_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, seq_len=seq_len)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # a window >= S masks as little as none; min() keeps it a C int
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    ctypes.addressof(strides), B, H, k.shape[1], S, dh,
                    seq_len, int(causal), min(window, S),
                    1.0 / dh ** 0.5, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    flash_attention_bhsd.launches += 1
    return out


#: kernel launches so far in this process (CPU calls do not count)
flash_attention_bhsd.launches = 0
