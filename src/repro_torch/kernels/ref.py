"""Plain PyTorch versions of the main-path kernels: the twins of the JAX
package's ``kernels/ref.py`` oracles.  The CPU path of ``ops`` runs
these, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.  Masks use ``NEG_INF = -1e30`` (a fully masked row is uniform,
not NaN) and argmax keeps the first index of a tie.  The SSD scan's
oracles work in fp32 whatever the input type, as ``ssd_chunked`` does."""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, return_lse=False):
    """q: (B,Sq,H,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv) -> (B,Sq,H,Dv)
    — plain softmax attention at scale D ** -0.5, query head h reading KV
    head h // (H // Hkv), the causal mask top-left aligned (qpos >= kpos,
    both from 0).  With ``return_lse`` also each row's log-sum-exp of the
    scaled, masked scores, fp32 (B,H,Sq)."""
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
    o = o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return o


def decode_attention_ref(q, k, v, kv_len, return_lse=False):
    """q: (B,H,D); k,v: (B,S,Hkv,D); kv_len: int, () or (B,) valid
    lengths, each >= 0.  A sequence with no valid position gives out 0
    (and lse NEG_INF), as the kernel does.  With ``return_lse`` also each
    head's log-sum-exp of its scaled, masked scores, fp32 (B,H)."""
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
    some = (kl > 0)[:, None, None, None]
    o = torch.where(some, o, 0.0)
    o = o.reshape(B, H, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(some[..., 0], torch.logsumexp(s, dim=-1), NEG_INF)
    return o, lse.reshape(B, H)


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


def int8_quantize_ref(x):
    """Row-wise absmax int8 quantization.  x: (N, D) -> (q int8 (N, D),
    scale fp32 (N,)).  IEEE divisions and round half to even, as the
    JAX oracle on the CPU.  The 127 is a tensor: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, one ulp off the
    division, and a scale one ulp off moves x / scale across a .5 tie."""
    xf = x.to(F32)
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def int8_dequantize_ref(q, scale):
    return q.to(F32) * scale[:, None]


def _heads(t, H):
    """(B, S, G, N) group-level B or C as (B, S, H, N): head h reads group
    ``h // (H // G)``, as ``jnp.repeat`` lays them out in ``mamba2_fwd``."""
    G = t.shape[2]
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    return t if G == H else t.repeat_interleave(H // G, dim=2)


def ssm_chunk_scan_ref(x, dt, A, Bm, Cm, chunk, h0=None):
    """The torch twin of ``repro/models/ssm.py::ssd_chunked``: the SSD
    scan over chunks of ``Lc = min(chunk, S)`` positions, in fp32.
    x: (B,S,H,P); dt: (B,S,H) post-softplus; A: (H,) negative; Bm, Cm:
    (B,S,G,N) with G dividing H (G == H: already repeated to heads);
    h0: optional (B,H,P,N) initial state.  Returns (y (B,S,H,P) fp32,
    final state (B,H,P,N) fp32).  Raises ValueError where the reference
    asserts: S must be a multiple of Lc.

    The decay exp(l_t - l_s) is masked to s <= t BEFORE the exp (the
    reference masks after it with ``jnp.where``; the kept values are the
    same), so the masked half, where l_t - l_s > 0 can overflow, never
    produces inf."""
    Bt, S, H, P = x.shape
    Bm, Cm = _heads(Bm, H), _heads(Cm, H)
    N = Bm.shape[-1]
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"ssm_chunk_scan: length {S} is not a multiple of "
                         f"the chunk {Lc}")
    nc = S // Lc
    xc = x.reshape(Bt, nc, Lc, H, P).to(F32)
    dtc = dt.reshape(Bt, nc, Lc, H).to(F32)
    Bc = Bm.reshape(Bt, nc, Lc, H, N).to(F32)
    Cc = Cm.reshape(Bt, nc, Lc, H, N).to(F32)

    cum = torch.cumsum(dtc * A.to(F32), dim=2)            # l_t (B,nc,Lc,H)
    lt = cum.permute(0, 1, 3, 2)                          # (B,nc,H,Lc)
    dts = dtc.permute(0, 1, 3, 2)
    # intra-chunk quadratic form: W[t,s] = (C_t . B_s) exp(l_t - l_s) dt_s
    smat = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=x.device).tril()
    decay = (lt[..., :, None] - lt[..., None, :]).masked_fill(~tri,
                                                             float("-inf"))
    W = smat * torch.exp(decay) * dts[..., None, :]
    y_intra = torch.einsum("bchls,bcshp->bclhp", W, xc)
    # per-chunk end state: sum_s exp(l_L - l_s) dt_s x_s (x) B_s
    wS = torch.exp(lt[..., -1:] - lt) * dts
    hc = torch.einsum("bchs,bcshn,bcshp->bchpn", wS, Bc, xc)
    # inter-chunk sequential scan
    chunk_decay = torch.exp(lt[..., -1])                  # (B,nc,H)
    h = (torch.zeros((Bt, H, P, N), dtype=F32, device=x.device)
         if h0 is None else h0.to(F32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                 # state before c
        h = h * chunk_decay[:, c, :, None, None] + hc[:, c]
    y_inter = torch.einsum("bclhn,bchpn->bclhp", Cc * torch.exp(cum)[..., None],
                           torch.stack(h_prevs, dim=1))
    return (y_intra + y_inter).reshape(Bt, S, H, P), h


def ssm_sequential_ref(x, dt, A, Bm, Cm):
    """Step-by-step SSM recurrence (the definitional ground truth), in
    fp32.  x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,G,N), G
    dividing H.  Returns (y (B,S,H,P), final state (B,H,P,N))."""
    B, S, H, P = x.shape
    Bm, Cm = _heads(Bm, H).to(F32), _heads(Cm, H).to(F32)
    x, dt, A = x.to(F32), dt.to(F32), A.to(F32)
    h = torch.zeros((B, H, P, Bm.shape[-1]), dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                   # (B,H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h
