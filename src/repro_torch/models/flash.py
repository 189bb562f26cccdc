"""Flash attention for the port: the twin of the JAX package's
``models/flash.py``, forward and backward.

The JAX module is flash attention in plain jnp with a ``custom_vjp``
backward, and ``repro.kernels.flash_attention`` is its Pallas twin of the
forward pass.  Here the forward pass is the hand-written kernel
(``kernels.ops``: the CUDA kernel for a CUDA tensor, the plain PyTorch
version for a CPU tensor).  Under autograd it runs inside
``FlashAttention``, a ``torch.autograd.Function`` whose forward also
takes the rows' log-sum-exp from the kernel and saves (q, k, v, out,
lse), O(S * D) and no probability tensor; its backward is the twin of
the reference's ``_flash_bwd_impl`` (``repro/models/flash.py:134-201``),
which is plain jnp and not a Pallas kernel, so it is plain PyTorch here:
key blocks outside, query blocks inside, probabilities recomputed from
the lse, fp32 accumulation.  Layout: q (B, Sq, H, D); k (B, Skv, Hkv,
D); v (B, Skv, Hkv, Dv), Dv = D except for MLA's expanded prefill (D
192, Dv 128)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

F32 = torch.float32
BLOCK = 1024                # the reference's block_q = block_k


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_seq(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad axis 1 of ``x`` to ``target``."""
    if x.shape[1] == target:
        return x
    pad = x.new_zeros((x.shape[0], target - x.shape[1], *x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _block_mask(qpos, kpos, causal: bool, window: int, kv_limit: int):
    m = (kpos < kv_limit)[None, :]
    if causal:
        m = m & (qpos[:, None] >= kpos[None, :])
    if window:
        m = m & ((qpos[:, None] - kpos[None, :]) < window)
    return m


def flash_bwd(q, k, v, out, lse, dout, *, causal: bool, window: int):
    """(dq, dk, dv) of flash attention in the inputs' types: the twin of
    ``_flash_bwd_impl``.  lse: (B, H, Sq) fp32 from the forward pass.
    Blocks of ``min(1024, ceil128(S))`` along each sequence, padded with
    zeros; ``delta = rowsum(dO * O)``; the softmax scale folded into q, so
    ``ds^T q`` already carries it for dk and dq takes it once more."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    bq = min(BLOCK, _ceil_to(Sq, 128))
    bk = min(BLOCK, _ceil_to(Skv, 128))
    Sq_pad, Skv_pad = _ceil_to(Sq, bq), _ceil_to(Skv, bk)
    scale = D ** -0.5
    kp = _pad_seq(k, Skv_pad).to(F32)
    vp = _pad_seq(v, Skv_pad).to(F32)
    qp = _pad_seq(q.reshape(B, Sq, Hkv, g, D), Sq_pad).to(F32) * scale
    dop = _pad_seq(dout.reshape(B, Sq, Hkv, g, Dv), Sq_pad).to(F32)
    op = _pad_seq(out.reshape(B, Sq, Hkv, g, Dv), Sq_pad).to(F32)
    lsep = F.pad(lse.reshape(B, Hkv, g, Sq).to(F32), (0, Sq_pad - Sq))
    delta = (dop * op).sum(-1).permute(0, 2, 3, 1)          # (B,Hkv,g,Sq)
    dq = torch.zeros((B, Sq_pad, Hkv, g, D), dtype=F32, device=q.device)
    dk = torch.zeros((B, Skv_pad, Hkv, D), dtype=F32, device=q.device)
    dv = torch.zeros((B, Skv_pad, Hkv, Dv), dtype=F32, device=q.device)
    for j0 in range(0, Skv_pad, bk):
        kbj, vbj = kp[:, j0:j0 + bk], vp[:, j0:j0 + bk]
        kpos = j0 + torch.arange(bk, device=q.device)
        for i0 in range(0, Sq_pad, bq):
            qbi, dobi = qp[:, i0:i0 + bq], dop[:, i0:i0 + bq]
            lsei, deli = lsep[..., i0:i0 + bq], delta[..., i0:i0 + bq]
            qpos = i0 + torch.arange(bq, device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qbi, kbj)
            msk = _block_mask(qpos, kpos, causal, window, Skv)
            p = torch.where(msk, torch.exp(s - lsei[..., None]), 0.0)
            dv[:, j0:j0 + bk] += torch.einsum("bhgqk,bqhgd->bkhd", p, dobi)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dobi, vbj)
            ds = p * (dp - deli[..., None])
            dk[:, j0:j0 + bk] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qbi)
            dq[:, i0:i0 + bq] += torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                              kbj) * scale
    return (dq[:, :Sq].reshape(B, Sq, H, D).to(q.dtype),
            dk[:, :Skv].to(k.dtype), dv[:, :Skv].to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's flash backward: the forward
    launches the kernel with its lse output (the plain version on the
    CPU) and saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                               window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int = 0, kv_len=None) -> torch.Tensor:
    """Grouped-GQA flash attention.  Under autograd (grad enabled and an
    input that requires grad) it goes through ``FlashAttention``; else
    the forward kernel alone, with no lse.

    ``q_offset`` and ``kv_len`` (prefill continuation, decode against a
    partly filled cache) are used by no prefill and no training step of
    the port, and raise rather than being ignored."""
    if q_offset or kv_len is not None:
        raise NotImplementedError(
            "flash_attention: q_offset and kv_len are not ported (the "
            "monolithic prefill and the training step use neither)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), int(window))
    return ops.flash_attention(q, k, v, causal=causal, window=window)
