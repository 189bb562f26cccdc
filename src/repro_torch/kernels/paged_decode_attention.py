"""Paged decode attention on Hopper: the ctypes wrapper of
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/paged_decode_attention.py``
(``paged_decode_attention_kernel``): one query token per sequence
against a paged KV pool ``(n_pages, page_size, Hkv, D)`` through
``block_tables (B, max_pages)``, online softmax over the pages that hold
``kv_len`` positions, any number of query heads per KV head.  The
source files (``paged_decode_attention.cu`` and the split-KV design it
shares with the contiguous kernel, ``split_decode.cuh``) carry the note
on what bounds the kernel and how its design answers it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_HEAD_DIM = 128
MAX_PAGE_SIZE = 128
_INVALID_VALUE = 1       # cudaErrorInvalidValue: sizes the kernel refuses


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables, kv_len):
    """q: (B, H, D) float32/bfloat16 on CUDA; k_pages, v_pages:
    (n_pages, page_size, Hkv, D) of q's type; block_tables:
    (B, max_pages) int32 page ids (unused entries 0, the scratch page);
    kv_len: (B,) int32 valid positions per sequence, each >= 1.
    Returns (B, H, D) in q's type.  Launches on the current stream."""
    global launches
    B, H, D = q.shape
    n_pages, ps, Hkv, Dk = k_pages.shape
    tensors = (q, k_pages, v_pages, block_tables, kv_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_decode_attention: every input must be a "
                         "CUDA tensor on one device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_decode_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k_pages.dtype}, "
                         f"{v_pages.dtype}")
    if v_pages.shape != k_pages.shape or Dk != D or H % Hkv:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)},"
                         f" pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("paged_decode_attention: block_tables must be "
                         f"(B={B}, max_pages) int32")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError(f"paged_decode_attention: kv_len must be (B={B},) "
                         "int32")
    if D > MAX_HEAD_DIM or D % 8 or ps > MAX_PAGE_SIZE:
        raise ValueError(f"paged_decode_attention: head_dim {D} (a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}) or page_size {ps} (max "
                         f"{MAX_PAGE_SIZE}) not taken")
    q, k_pages, v_pages, block_tables, kv_len = (
        t.contiguous() for t in tensors)
    if q.data_ptr() % 16:             # the kernel reads q in 16-byte pieces
        q = q.clone()
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention: K/V pages must start on "
                         "a 16-byte boundary (the kernel reads 16-byte "
                         "vectors)")
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    fn = build.function("paged_decode_attention", "paged_decode_attention",
                        _ARGTYPES)
    # the workspace argument is unused (the splits merge in the cluster)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
             None, B, H, Hkv, D, ps, max_pages, n_pages,
             D ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err == _INVALID_VALUE:
        raise ValueError(f"paged_decode_attention: group {H // Hkv} at "
                         f"head_dim {D} not taken (more query heads than "
                         "the kernel's registers and shared memory hold, "
                         "or a cluster the card cannot place)")
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def plan(B, H, Hkv, D, page_size, max_pages, dtype) -> dict:
    """How the kernel cuts a call with these sizes: ``C`` CTAs a
    (sequence, KV head) cluster, ``tile`` positions a staged tile and
    the shared memory of a CTA (``smem_bytes``).  Needs the card."""
    out = (ctypes.c_int * 3)()
    fn = build.function("paged_decode_attention",
                        "paged_decode_attention_plan",
                        [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(B, H, Hkv, D, page_size, max_pages, _DTYPES[dtype], out)
    if err:
        raise ValueError(f"paged_decode_attention: sizes not taken "
                         f"(cudaError {err})")
    return dict(C=out[0], tile=out[1], smem_bytes=out[2])


def work(B: int, H: int, Hkv: int, D: int, lens, dtype,
         page_size: int) -> dict:
    """The contiguous kernel's work (``decode_attention.work``) plus the
    block-table entries that hold the valid positions."""
    from repro_torch.kernels import decode_attention
    w = decode_attention.work(B, H, Hkv, D, lens, dtype)
    w["bytes"] += 4 * sum(-(-int(n) // page_size) for n in lens)
    return w
