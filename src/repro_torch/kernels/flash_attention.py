"""Causal GQA flash attention: the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernels replace ``src/repro/kernels/flash_attention.py::
flash_attention_bhsd`` (the Pallas TPU kernel); the source's header says
what bounds them on an H100 and what their design does about that.  This
wrapper keeps the JAX layout and meaning, checks its inputs, picks the
kernel (``variant``), allocates the output, launches on the current stream
and counts launches, in total and by variant.  A tensor on the CPU takes
the plain version, ``ref.ref_flash_attention``, at any head dim; a CUDA
tensor launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blocked_matmul import refuse_autograd
from repro_torch.kernels.ref import ref_flash_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for (smollm's 64; 128 for the 7B/8B
#: configs and the JAX package's tests)
HEAD_DIMS = (64, 128)
_GRID_MAX = 65535   # gridDim.y (heads) and gridDim.z (batch)
_INT_MAX = 2 ** 31 - 1

#: the kernels, in ``variant``'s words: the Hopper TMA + wgmma kernel, the
#: first design's mma.sync kernel, IEEE fp32 on the CUDA cores
VARIANTS = ("sm90", "mma", "f32")


def bind(lib: ctypes.CDLL):
    """The typed ``(flash_attention_launch, flash_attention_sm90_launch)``
    of a library built from ``csrc/flash_attention.cu`` (or an edited
    copy of it)."""
    head = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float]
    base, sm90 = lib.flash_attention_launch, lib.flash_attention_sm90_launch
    base.argtypes = head + [ctypes.c_int, ctypes.c_void_p]   # + dtype
    sm90.argtypes = head + [ctypes.c_void_p]
    for fn in (base, sm90):
        fn.restype = ctypes.c_int
    return base, sm90


@functools.cache
def _launcher():
    return bind(_build.load("flash_attention"))


def tma_readable(*xs: torch.Tensor) -> bool:
    """Whether TMA can read each (B, heads, S, dh) tensor as the sm90
    kernel encodes it, beyond what ``_check_cuda`` demands: no stride 0
    (a broadcast view) on a dimension longer than 1."""
    return all(s != 0 for x in xs for n, s in zip(x.shape, x.stride())
               if n > 1)


def variant(dtype: torch.dtype, dh: int, is_tma_readable: bool) -> str:
    """The kernel that takes a call, by dtype, head dim and layout alone.

    fp32 goes to f32 (IEEE, no TF32).  bf16 goes to sm90 at the head dims
    it is built for (64 and 128, as the mma kernel) when TMA can read the
    tensors (``tma_readable``), otherwise to mma.
    """
    if dtype == torch.float32:
        return "f32"
    if dh in HEAD_DIMS and is_tma_readable:
        return "sm90"
    return "mma"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           seq_len: Optional[int]) -> None:
    _build.refuse_dtensor(q=q, k=k, v=v)
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
    Forward only: a CUDA input that requires grad while grad mode is on
    raises (the CPU's plain version stays differentiable).
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
    refuse_autograd("flash_attention_bhsd", q, k, v)
    kind = variant(q.dtype, dh, tma_readable(q, k, v))
    out = torch.empty_like(q)
    rc = launch(_launcher(), kind, q, k, v, out, causal, window, seq_len)
    if rc != 0:
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: "
                           f"CUDA error {rc} at q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {q.dtype}")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_variant[kind] += 1
    return out


def launch(fns, kind: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, out: torch.Tensor, causal: bool, window: int,
           seq_len: int) -> int:
    """One launch of the ``kind`` kernel from ``fns`` (what ``bind``
    returns) on CUDA tensors that passed the checks; counts nothing.
    Returns the CUDA error code.  ``chip_smoke.py`` calls it directly to
    time the kernel the rule does not pick."""
    base, sm90 = fns
    B, H, S, dh = q.shape
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        # a window >= S masks as little as none; min() keeps it a C int
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(strides), B, H, k.shape[1], S, dh, seq_len,
                int(causal), min(window, S), 1.0 / dh ** 0.5)
        if kind == "sm90":
            return sm90(*args, stream)
        return base(*args, _DTYPE_CODE[q.dtype], stream)


#: kernel launches so far in this process (CPU calls do not count), in total
#: and by ``variant``
flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_variant = dict.fromkeys(VARIANTS, 0)
