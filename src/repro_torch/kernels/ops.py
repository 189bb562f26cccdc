"""Kernel dispatch: a CUDA tensor goes to the hand-written Hopper kernel
(or the call raises), a CPU tensor to the plain PyTorch version in
``ref.py``, a meta tensor to the kernel's shapes.  There is no fallback
from one to the other: the device of the input decides, as the JAX
package's ``interpret=not on_tpu()`` does.  Every kernel wrapper counts
its launches; ``launch_counts`` reads the counts and ``reset_launches``
sets them to 0, so a run can show that its main path went through the
kernels.

On the meta device (the dry-run, ``launch.dryrun``) an op returns the
kernel's outputs as meta tensors and charges the active step counter
(``analysis.hlo``) the kernel's own work, its wrapper's ``work()``: the
plain version is not traced (the plain flash would build (B, H, S, S)
scores and count the masked half, which the card never runs).  It
launches nothing and counts no launch."""
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


def _route(x: torch.Tensor, op: str) -> str:
    """"cuda" (the kernel), "cpu" (the plain version) or "meta" (the
    kernel's shapes and work)."""
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{op}: no kernel or plain version for device "
                         f"{x.device}")
    return kind


def _meta(x: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype or x.dtype, device="meta")


def _charge(name: str, work: dict) -> None:
    from repro_torch.analysis import hlo
    hlo.charge_kernel(name, work)


def _full_lengths(kv_len, B: int, S: int) -> list:
    """Valid lengths a meta call reads: an int's own, else (a tensor,
    whose values a meta tensor does not hold) the whole cache, the
    dry-run's full cache."""
    if isinstance(kv_len, int):
        return [min(kv_len, S)] * B
    return [S] * B


def flash_attention(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: (B,Sq,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv) ->
    (B,Sq,H,Dv), and with ``return_lse`` also the rows' log-sum-exp, fp32
    (B,H,Sq).  At Sq != Skv the causal mask is top-left aligned (query i
    sees keys 0..i), as in the Pallas kernel."""
    kw = dict(causal=causal, window=window, return_lse=return_lse)
    route = _route(q, "flash_attention")
    if route == "cuda":
        return _flash.flash_attention_kernel(q, k, v, **kw)
    if route == "cpu":
        return ref.flash_attention_ref(q, k, v, **kw)
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    _charge("flash_attention", _flash.work(B, Sq, Skv, H, Hkv, D, Dv,
                                           q.dtype, **kw))
    out = _meta(q, (B, Sq, H, Dv))
    if return_lse:
        return out, _meta(q, (B, H, Sq), torch.float32)
    return out


def decode_attention(q, k, v, kv_len, return_lse=False):
    """q: (B,H,D); k,v: (B,S,Hkv,D) one layer's cache; kv_len: int, ()
    or (B,) int32 valid lengths (0: out 0, lse -1e30) -> (B,H,D), and
    with ``return_lse`` also the heads' log-sum-exp, fp32 (B,H).  On meta
    a tensor ``kv_len`` charges the whole cache (``_full_lengths``)."""
    route = _route(q, "decode_attention")
    if route == "cuda":
        return _decode.decode_attention_kernel(q, k, v, kv_len,
                                               return_lse=return_lse)
    if route == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_len,
                                        return_lse=return_lse)
    B, H, D = q.shape
    _charge("decode_attention", _decode.work(
        B, H, k.shape[2], D, _full_lengths(kv_len, B, k.shape[1]), q.dtype,
        return_lse))
    out = _meta(q, q.shape)
    if return_lse:
        return out, _meta(q, (B, H), torch.float32)
    return out


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len):
    """q: (B,H,D); pages (n_pages, page_size, Hkv, D); block_tables
    (B, max_pages) int32; kv_len (B,) int32 -> (B,H,D).  On meta the
    tables' every page is charged."""
    route = _route(q, "paged_decode_attention")
    if route == "cuda":
        return _paged.paged_decode_attention_kernel(q, k_pages, v_pages,
                                                    block_tables, kv_len)
    if route == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, kv_len)
    B, H, D = q.shape
    ps = k_pages.shape[1]
    _charge("paged_decode_attention", _paged.work(
        B, H, k_pages.shape[2], D, [block_tables.shape[1] * ps] * B,
        q.dtype, ps))
    return _meta(q, q.shape)


def ssm_chunk_scan(x, dt, A, Bm, Cm, *, chunk=256, h0=None):
    """Mamba2 SSD chunked scan.  x: (B,S,H,P); dt: (B,S,H) fp32; A: (H,)
    fp32; Bm, Cm: (B,S,G,N), G dividing H -> (y (B,S,H,P) fp32, final
    state (B,H,P,N) fp32).  The kernel starts from a zero state: an
    ``h0`` on CUDA raises (nothing on the serving path passes one)."""
    route = _route(x, "ssm_chunk_scan")
    if route == "cpu":
        return ref.ssm_chunk_scan_ref(x, dt, A, Bm, Cm, chunk, h0=h0)
    if h0 is not None:
        raise NotImplementedError(
            "ssm_chunk_scan: the CUDA kernel takes no initial state h0")
    if route == "cuda":
        return _ssm.ssm_chunk_scan_kernel(x, dt, A, Bm, Cm, chunk=chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    _charge("ssm_chunk_scan", _ssm.work(B, S, H, P, N, G, chunk, x.dtype))
    f32 = torch.float32
    return _meta(x, (B, S, H, P), f32), _meta(x, (B, H, P, N), f32)


def confidence_gate(logits):
    """logits: (B, V) -> dict(max_prob, entropy, margin, argmax)."""
    route = _route(logits, "confidence_gate")
    if route == "cuda":
        return _gate.confidence_gate_kernel(logits)
    if route == "cpu":
        return ref.confidence_gate_ref(logits)
    B, V = logits.shape
    _charge("confidence_gate", _gate.work(B, V, logits.dtype))
    out = {k: _meta(logits, (B,), torch.float32)
           for k in ("max_prob", "entropy", "margin")}
    return {**out, "argmax": _meta(logits, (B,), torch.int32)}


def int8_quantize(x):
    """x: (N, D) -> (q int8 (N, D), scale fp32 (N,)): row-wise absmax
    quantization, ``q = clip(round(x / scale), +-127)``."""
    route = _route(x, "int8_quantize")
    if route == "cuda":
        return _int8.int8_quantize_kernel(x)
    if route == "cpu":
        return ref.int8_quantize_ref(x)
    N, D = x.shape
    _charge("int8_quantize", _int8.work(N, D, x.dtype))
    return _meta(x, (N, D), torch.int8), _meta(x, (N,), torch.float32)
