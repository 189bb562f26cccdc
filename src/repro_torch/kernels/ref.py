"""Plain PyTorch versions of the main-path kernels: the twins of the JAX
package's ``kernels/ref.py`` oracles.  The CPU path of ``ops`` runs
these, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.  Masks use ``NEG_INF = -1e30`` (a fully masked row is uniform,
not NaN) and argmax keeps the first index of a tie."""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,S,H,D); k,v: (B,S,Hkv,D) — plain softmax attention, query
    head h reading KV head h // (H // Hkv)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, D).to(F32) * D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32))
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len):
    """q: (B,H,D); k,v: (B,S,Hkv,D); kv_len: int, () or (B,) valid
    lengths."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, D).to(F32) * D ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.to(F32))
    kl = torch.as_tensor(kv_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(B)
    mask = torch.arange(S, device=q.device)[None, :] < kl[:, None]  # (B,S)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.to(F32))
    return o.reshape(B, H, v.shape[-1]).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_len):
    """Gather version of the paged decode kernel.  q: (B,H,D);
    k_pages/v_pages: (n_pages, page_size, Hkv, D); block_tables:
    (B, max_pages) int32 (positions [j*ps, (j+1)*ps) of sequence b live
    in page block_tables[b, j]); kv_len: int or (B,) valid positions."""
    B = q.shape[0]
    bt = block_tables.long()
    kg = k_pages[bt].reshape(B, -1, *k_pages.shape[2:])
    vg = v_pages[bt].reshape(B, -1, *v_pages.shape[2:])
    return decode_attention_ref(q, kg, vg, kv_len)


def confidence_gate_ref(logits):
    """Confidence metrics over vocab logits (B, V), math in fp32:
    dict(max_prob, entropy, margin, argmax)."""
    x = logits.to(F32)
    p = torch.softmax(x, dim=-1)
    top2 = torch.topk(p, 2, dim=-1).values
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)),
                                 0.0), dim=-1)
    return {
        "max_prob": p.max(dim=-1).values,
        "entropy": ent,
        "margin": top2[..., 0] - top2[..., 1],
        # torch.argmax returns the first maximal index, as jnp.argmax does
        "argmax": torch.argmax(x, dim=-1).to(torch.int32),
    }
