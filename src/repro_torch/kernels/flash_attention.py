"""Flash prefill attention on Hopper: the ctypes wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_kernel``): FlashAttention-2's forward pass with GQA,
causal and sliding-window masks and fp32 online softmax, which every
monolithic prefill runs once per layer.  bfloat16 inputs take the
tensor-core design (mma.sync, cp.async tiles), float32 inputs the
CUDA-core one (exact fp32 products).  The source file carries the note
on what bounds the kernel and how each design answers it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
MAX_HEAD_DIM = 128
MAX_GROUP = 8


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D); k, v: (B, S, Hkv, D), float32 or bfloat16 on one
    CUDA device, each with a contiguous last axis (other strides are
    read as they are).  bfloat16 also needs D % 16 == 0, 16-byte aligned
    data and strides that are multiples of 8 (the tensor-core tiles are
    copied in 16-byte pieces); a tensor that breaks either raises.
    Returns (B, S, H, D) in q's type.  Launches on the current stream."""
    global launches
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be CUDA tensors "
                         "on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, S, H, D) and two (B, S, Hkv, D)")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if D > MAX_HEAD_DIM or D % 8 or H // Hkv > MAX_GROUP or S < 1:
        raise ValueError(f"flash_attention: head_dim {D} (a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}), group {H // Hkv} (max "
                         f"{MAX_GROUP}) or length {S} not taken")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    if q.dtype == torch.bfloat16 and (D % 16 or not all(
            build.rows_aligned(t) for t in (q, k, v))):
        raise ValueError(f"flash_attention: bfloat16 takes head_dim a "
                         f"multiple of 16 (got {D}) and 16-byte aligned "
                         f"rows (data_ptr % 16 == 0, strides % 8 == 0)")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], B, S, H, Hkv, D, int(bool(causal)),
             int(window), D ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return out
