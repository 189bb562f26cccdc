"""Contiguous decode attention on Hopper: the ctypes wrapper of
``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention_kernel``): one query token per sequence against one
layer's contiguous KV cache ``(B, S, Hkv, D)`` with a valid length per
sequence, the g query heads of a KV head together, any g, with each
head's log-sum-exp beside the output on request (a rank's partial
softmax over its slice of a cache cut on its positions).  The source files
(``decode_attention.cu`` and the split-KV design it shares with the
paged kernel, ``split_decode.cuh``) carry the note on what bounds the
kernel and how its design answers it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_HEAD_DIM = 128
_INVALID_VALUE = 1       # cudaErrorInvalidValue: sizes the kernel refuses


def decode_attention_kernel(q, k, v, kv_len, return_lse=False):
    """q: (B, H, D) float32/bfloat16 on CUDA; k, v: (B, S, Hkv, D) of q's
    type, contiguous (one layer's view of the cache: the kernel reads it
    in place, so nothing here copies it); kv_len: an int, a 0-d or a
    (B,) int32 tensor of valid positions per sequence, each >= 0
    (positions at or past it are never read; a sequence with none gives
    out 0 and lse -1e30).  Returns (B, H, D) in q's type, and with
    ``return_lse`` also each head's log-sum-exp of its scaled scores,
    fp32 (B, H).  Launches on the current stream."""
    global launches
    B, H, D = q.shape
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be CUDA "
                         "tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         "match")
    S, Hkv = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"decode_attention: head_dim {D} (a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}) not taken")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: the cache views k and v must "
                         "be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k/v must start on a 16-byte "
                         "boundary (the kernel reads 16-byte vectors)")
    if isinstance(kv_len, int):
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
    if not (kv_len.is_cuda and kv_len.device == q.device) \
            or kv_len.dtype != torch.int32 or kv_len.dim() > 1 \
            or kv_len.numel() not in (1, B):
        raise ValueError(f"decode_attention: kv_len must be an int or a "
                         f"() / (B={B},) int32 tensor on q's device")
    kv_len = kv_len.reshape(-1).expand(B).contiguous()
    q = q.contiguous()
    if q.data_ptr() % 16:             # the kernel reads q in 16-byte pieces
        q = q.clone()
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.function("decode_attention", "decode_attention", _ARGTYPES)
    # the workspace argument is unused (the splits merge in the cluster)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), None if lse is None else lse.data_ptr(), None,
             B, H, Hkv, D, S, D ** -0.5,
             _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err == _INVALID_VALUE:
        raise ValueError(f"decode_attention: group {H // Hkv} at head_dim "
                         f"{D} not taken (more query heads than the "
                         "kernel's registers and shared memory hold, or a "
                         "cluster the card cannot place)")
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def plan(B, H, Hkv, D, S, dtype) -> dict:
    """How the kernel cuts a call with these sizes: ``C`` CTAs a
    (sequence, KV head) cluster, ``tile`` positions a staged tile and
    the shared memory of a CTA (``smem_bytes``).  Needs the card."""
    out = (ctypes.c_int * 3)()
    fn = build.function("decode_attention", "decode_attention_plan",
                        [ctypes.c_int] * 6 + [ctypes.c_void_p])
    err = fn(B, H, Hkv, D, S, _DTYPES[dtype], out)
    if err:
        raise ValueError(f"decode_attention: sizes not taken (cudaError "
                         f"{err})")
    return dict(C=out[0], tile=out[1], smem_bytes=out[2])


def work(B: int, H: int, Hkv: int, D: int, lens, dtype,
         return_lse: bool = False) -> dict:
    """The least work of one launch at valid lengths ``lens`` (one a
    sequence): each valid K/V row read once, q read and out written once,
    the lengths read, the fp32 lse written with ``return_lse``; QK and PV
    over the valid positions, on the tensor cores for bfloat16."""
    item = torch.empty((), dtype=dtype).element_size()
    n_pos = int(sum(int(n) for n in lens))
    return dict(bytes=2 * n_pos * Hkv * D * item + 2 * B * H * D * item
                + 4 * B + (4 * B * H if return_lse else 0),
                flops=4 * n_pos * H * D,
                tensor_cores=dtype == torch.bfloat16)
