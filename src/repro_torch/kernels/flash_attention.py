"""Flash prefill attention on Hopper: the ctypes wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_kernel``): FlashAttention-2's forward pass with GQA,
causal and sliding-window masks and fp32 online softmax, which every
monolithic prefill runs once per layer (DeepSeek-V3's expanded MLA
prefill with a q/k head dim of 192 and a v head dim of 128 among them;
whisper's cross-attention with a query length other than the key
length, as the Pallas kernel takes them).
bfloat16 inputs take the
tensor-core design (mma.sync, cp.async tiles), float32 inputs the
CUDA-core one (exact fp32 products).  With ``return_lse`` the kernel
also writes each row's log-sum-exp, which the training backward
(``models.flash``) recomputes the probabilities from.  The source file
carries the note on what bounds the kernel and how each design answers
it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
MAX_HEAD_DIM = 128          # q/k = v
MAX_SLICE = 8               # query heads of one KV head a CTA serves
# (q/k, v) head dims the kernel is built for besides D = Dv, in both
# types: MLA's expanded prefill
SPLIT_DIMS = ((192, 128),)


def group_slice(g: int) -> int:
    """Query heads a CTA serves at GQA group ``g``: g up to MAX_SLICE,
    else the largest divisor of g up to MAX_SLICE (48 -> 8, 12 -> 6, a
    prime -> 1); the kernel's grid y then runs over H // group_slice(g)
    slices, slice i holding query heads i * gs .. i * gs + gs - 1 of KV
    head i * gs // g.  The host side of ``flash_attention.cu`` computes
    the same."""
    gs = min(g, MAX_SLICE)
    while g % gs:
        gs -= 1
    return gs


def flash_attention_kernel(q, k, v, *, causal: bool = True, window: int = 0,
                           return_lse: bool = False):
    """q: (B, Sq, H, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv),
    float32 or bfloat16 on one CUDA device, each with a contiguous last
    axis (other strides are read as they are).  Sq may differ from Skv
    (cross-attention); the causal mask is then top-left aligned, query
    position i seeing keys 0..i, as in the Pallas kernel.  A window with
    Sq > Skv raises: it would leave rows with no key.  The head dims are D = Dv, a
    multiple of 8 (bfloat16: 16) up to 128, or (D, Dv) in
    ``SPLIT_DIMS``; any GQA group H // Hkv (``group_slice``); the
    softmax scale is D ** -0.5.  bfloat16 also needs
    16-byte aligned data and strides that are multiples of 8 (the
    tensor-core tiles are copied in 16-byte pieces); a tensor that
    breaks either raises.  Returns (B, Sq, H, Dv) in q's type, and with
    ``return_lse`` also the rows' log-sum-exp of the scaled scores, fp32
    (B, H, Sq) (head h reads KV head h // (H // Hkv)).  Launches on the
    current stream."""
    global launches
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be CUDA tensors "
                         "on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must share one of "
                         f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, Dv)")
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    step = 16 if q.dtype == torch.bfloat16 else 8
    if not ((D == Dv and D % step == 0 and D <= MAX_HEAD_DIM)
            or (D, Dv) in SPLIT_DIMS) or Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention: head dims q/k {D}, v {Dv} "
                         f"(equal and a multiple of {step} up to "
                         f"{MAX_HEAD_DIM}, or one of {SPLIT_DIMS}) or lengths "
                         f"{Sq}, {Skv} not taken")
    if window < 0 or (window and Sq > Skv):
        raise ValueError(f"flash_attention: window {window} not taken at "
                         f"Sq {Sq}, Skv {Skv} (negative, or Sq > Skv)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head_dim axis of q, k and v "
                         "must be contiguous")
    if q.dtype == torch.bfloat16 and not all(build.rows_aligned(t)
                                             for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 takes 16-byte aligned "
                         "rows (data_ptr % 16 == 0, strides % 8 == 0)")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], B, Sq, Skv, H, Hkv, D, Dv, int(bool(causal)),
             int(window), D ** -0.5, _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep, for one (batch, head): query i
    sees keys lo..hi-1 of Skv (causal top-left aligned, as the kernel)."""
    if not causal and not window:
        return Sq * Skv
    qp = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(qp + 1, max=Skv) if causal else torch.full_like(qp, Skv)
    lo = torch.clamp(qp - window + 1, min=0) if window else 0
    return int(torch.clamp(hi - lo, min=0).sum())


def work(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int, Dv: int,
         dtype, *, causal: bool = True, window: int = 0,
         return_lse: bool = False) -> dict:
    """The least work of one launch: q, k and v read and the output
    written once, each at its own head dim (and the fp32 lse written,
    with ``return_lse``); QK^T and PV over the pairs the masks keep
    (``pairs``), on the tensor cores for bfloat16."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bytes = item * (B * Sq * H * D + B * Skv * Hkv * (D + Dv)
                      + B * Sq * H * Dv)
    if return_lse:
        n_bytes += 4 * B * H * Sq
    return dict(bytes=n_bytes,
                flops=2 * B * H * (D + Dv) * pairs(Sq, Skv, causal, window),
                tensor_cores=dtype == torch.bfloat16)
