"""Kernel dispatch: a CUDA tensor goes to the hand-written Hopper kernel
(or the call raises), a CPU tensor to the plain PyTorch version in
``ref.py``.  There is no fallback from one to the other: the device of
the input decides, as the JAX package's ``interpret=not on_tpu()``
does.  Every kernel wrapper counts its launches; ``launch_counts`` reads
the counts and ``reset_launches`` sets them to 0, so a run can show that
its main path went through the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels import conf_gate as _gate
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import int8_quant as _int8
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ssm

_WRAPPERS = {"paged_decode_attention": _paged, "confidence_gate": _gate,
             "flash_attention": _flash, "decode_attention": _decode,
             "ssm_chunk_scan": _ssm, "int8_quantize": _int8}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in _WRAPPERS.items()}


def reset_launches() -> None:
    for mod in _WRAPPERS.values():
        mod.launches = 0


def _on_cuda(x: torch.Tensor, op: str) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{op}: no kernel or plain version for device "
                         f"{x.device}")
    return False


def flash_attention(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: (B,Sq,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv) ->
    (B,Sq,H,Dv), and with ``return_lse`` also the rows' log-sum-exp, fp32
    (B,H,Sq).  At Sq != Skv the causal mask is top-left aligned (query i
    sees keys 0..i), as in the Pallas kernel."""
    kw = dict(causal=causal, window=window, return_lse=return_lse)
    if _on_cuda(q, "flash_attention"):
        return _flash.flash_attention_kernel(q, k, v, **kw)
    return ref.flash_attention_ref(q, k, v, **kw)


def decode_attention(q, k, v, kv_len):
    """q: (B,H,D); k,v: (B,S,Hkv,D) one layer's cache; kv_len: int, ()
    or (B,) int32 valid lengths -> (B,H,D)."""
    if _on_cuda(q, "decode_attention"):
        return _decode.decode_attention_kernel(q, k, v, kv_len)
    return ref.decode_attention_ref(q, k, v, kv_len)


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len):
    """q: (B,H,D); pages (n_pages, page_size, Hkv, D); block_tables
    (B, max_pages) int32; kv_len (B,) int32 -> (B,H,D)."""
    if _on_cuda(q, "paged_decode_attention"):
        return _paged.paged_decode_attention_kernel(q, k_pages, v_pages,
                                                    block_tables, kv_len)
    return ref.paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_len)


def ssm_chunk_scan(x, dt, A, Bm, Cm, *, chunk=256, h0=None):
    """Mamba2 SSD chunked scan.  x: (B,S,H,P); dt: (B,S,H) fp32; A: (H,)
    fp32; Bm, Cm: (B,S,G,N), G dividing H -> (y (B,S,H,P) fp32, final
    state (B,H,P,N) fp32).  The kernel starts from a zero state: an
    ``h0`` on CUDA raises (nothing on the serving path passes one)."""
    if _on_cuda(x, "ssm_chunk_scan"):
        if h0 is not None:
            raise NotImplementedError(
                "ssm_chunk_scan: the CUDA kernel takes no initial state h0")
        return _ssm.ssm_chunk_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    return ref.ssm_chunk_scan_ref(x, dt, A, Bm, Cm, chunk, h0=h0)


def confidence_gate(logits):
    """logits: (B, V) -> dict(max_prob, entropy, margin, argmax)."""
    if _on_cuda(logits, "confidence_gate"):
        return _gate.confidence_gate_kernel(logits)
    return ref.confidence_gate_ref(logits)


def int8_quantize(x):
    """x: (N, D) -> (q int8 (N, D), scale fp32 (N,)): row-wise absmax
    quantization, ``q = clip(round(x / scale), +-127)``."""
    if _on_cuda(x, "int8_quantize"):
        return _int8.int8_quantize_kernel(x)
    return ref.int8_quantize_ref(x)
