"""Dense GQA attention: the twin of the JAX package's
``models/attention.py`` for the serving paths — its init (with zamba2's
wider shared-block input), full-sequence attention
for the monolithic prefill (the flash kernel; whisper's cross-attention
with K/V from the encoder, at Sq != Skv; Qwen2-VL's M-RoPE), single-token decode
against a contiguous cache (the contiguous decode kernel), and chunked
prefill into pages with paged single-token decode (the paged kernel).

KV caches and pools are updated IN PLACE (``pool[page, off] = k``) where
the JAX code returns a new array from ``.at[].set`` or
``dynamic_update_slice``: this is deliberate, so the ~1 GB cache of a
full-width model is never copied per layer and step.  Callers get the
same tensors back, which keeps the JAX signatures.

Under a serving mesh (``launch.sharding``) the GQA paths run on the
rank's whole heads (the head counts come from the weights' shapes) and
its slice of the pool, and ``w_o``'s partial sums meet in
``layers.tp_sum``; on CUDA the paged decode kernel reads the rank's own
pool.  A contiguous cache follows the reference's rule
(``sharding.cache_logical_axes``): its KV heads cut with the weights',
or, where the KV heads do not divide 16, its positions cut over the
"seq" axes.  Decode over a cut sequence runs the contiguous decode
kernel on the rank's slice of the positions, which may hold none of a
sequence's, and merges the ranks' partial softmaxes by their
log-sum-exp after one exact gather; where the rank computes fewer heads
than the cache holds, the heads' q, k and v are gathered first.  The
reference turns its paged kernel off under a mesh, as its DMA addresses
one unsharded pool; each rank here owns a whole local pool, so the port
keeps it.  MLA's absorbed paths run on the rank's
slice of the latent rank: the contractions over it are partial sums
joined by an all-reduce, the scores before the softmax and the value
up-projection after it.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import pspec as PS
from repro_torch.models.flash import flash_attention

F32 = torch.float32
NEG_INF = -1e30


def init_attention(cfg: ModelConfig, gen, device, lead=(), d_in=None) -> dict:
    """GQA attention params with leading stack axes ``lead``.  ``d_in``
    overrides the input width (zamba2's shared block consumes
    concat(hidden, embedding), 2 * d_model)."""
    dt = L.dtype_of(cfg.param_dtype)
    d, hd = d_in or cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = {"w_q": L.dense_init((*lead, d, H * hd), dt, gen, device),
         "w_k": L.dense_init((*lead, d, Hkv * hd), dt, gen, device),
         "w_v": L.dense_init((*lead, d, Hkv * hd), dt, gen, device),
         "w_o": L.dense_init((*lead, H * hd, cfg.d_model), dt, gen, device)}
    if cfg.qkv_bias:
        p.update({k: torch.zeros((*lead, n * hd), dtype=dt, device=device)
                  for k, n in (("b_q", H), ("b_k", Hkv), ("b_v", Hkv))})
    if cfg.qk_norm:
        p.update(q_norm={"scale": torch.ones((*lead, hd), dtype=dt,
                                             device=device)},
                 k_norm={"scale": torch.ones((*lead, hd), dtype=dt,
                                             device=device)})
    return p


def _project_qkv(p: dict, cfg: ModelConfig, x, xkv=None):
    """q from x, k and v from ``xkv`` (cross-attention: the encoder's
    output) or x, each with its bias when the tree has one."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if p["w_q"].shape[-1] != cfg.n_heads * hd:     # this rank's heads
        # the replicated x and the per-head norms meet the rank's heads:
        # their gradients are partial sums over the heads' axes
        ax = L.tp_axis(p["w_q"].shape[-1], cfg.n_heads * hd)[1]
        x = L.to_model(x, ax)
        xkv = None if xkv is None else L.to_model(xkv, ax)
        if q_norm is not None:
            q_norm = {"scale": L.to_model(q_norm["scale"], ax)}
            k_norm = {"scale": L.to_model(k_norm["scale"], ax)}
    xkv = x if xkv is None else xkv
    q = x @ p["w_q"]
    k = xkv @ p["w_k"]
    v = xkv @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    # the rank's heads under a mesh: the widths say how many
    q = q.reshape(B, x.shape[1], -1, hd)
    k = k.reshape(B, xkv.shape[1], -1, hd)
    v = v.reshape(B, xkv.shape[1], -1, hd)
    if q_norm is not None:
        q = L.rmsnorm(q_norm, q, cfg.norm_eps)
        k = L.rmsnorm(k_norm, k, cfg.norm_eps)
    return q, k, v


def _out_proj(p: dict, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    """The output projection of (B, S, H_local * D) heads: row-parallel
    when ``w_o`` holds this rank's heads."""
    w = p["w_o"]
    return L.tp_sum(o @ w, w.shape[-2], cfg.n_heads * cfg.resolved_head_dim)


def _as_lengths(n, B: int, device) -> torch.Tensor:
    """An int or (B,) tensor of per-sequence bounds as a (B,) tensor."""
    return torch.as_tensor(n, dtype=torch.int32, device=device).reshape(-1) \
        .expand(B)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      window: int = 0, kv_len=None, kv_start=None,
                      block_q: int = 1024) -> torch.Tensor:
    """Memory-bounded attention.  q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D).

    q_offset: absolute position of q[0].  window: sliding-window size
    (0 = full).  kv_len / kv_start: optional int or (B,) bounds of the
    valid kv positions.  Scores and softmax in fp32; query blocks of
    ``block_q`` bound the score tensor as the JAX ``lax.scan`` does."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, g, D)
    kv_pos = torch.arange(Skv, device=q.device)
    kf, vf = k.to(F32), v.to(F32)
    kl = None if kv_len is None else _as_lengths(kv_len, B, q.device)
    ks = None if kv_start is None else _as_lengths(kv_start, B, q.device)
    outs = []
    for s0 in range(0, Sq, block_q):
        qb = qg[:, s0:s0 + block_q]
        qpos = q_offset + s0 + torch.arange(qb.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb.to(F32), kf) * scale
        mask = torch.ones((qb.shape[1], Skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qpos[:, None] >= kv_pos[None, :]
        if window:
            mask &= (qpos[:, None] - kv_pos[None, :]) < window
        mask = mask[None, None, None]                       # (1,1,1,bq,Skv)
        if kl is not None:
            mask = mask & (kv_pos[None, :] < kl[:, None])[:, None, None, None]
        if ks is not None:
            mask = mask & (kv_pos[None, :] >= ks[:, None])[:, None, None, None]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        outs.append(o.to(q.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, -1)


def _sections(cfg: ModelConfig):
    return cfg.mrope_sections if cfg.mrope else None


def attention_fwd(p: dict, cfg: ModelConfig, x, positions, *,
                  causal: bool = True, window: int = 0, mode: str = "flash",
                  xkv=None, rope: bool = True, return_kv: bool = False):
    """Full-sequence attention.  x: (B, S, d); positions: (B, S), or
    (3, B, S) for M-RoPE (``cfg.mrope``).  ``xkv`` (B, Skv, d): the
    source of k and v (whisper's cross-attention reads the encoder's
    output, Skv frames against S text positions); ``rope=False`` skips
    the rotary embedding (whisper).  Returns out, or (out, (k, v)) with
    k, v (B, Skv, Hkv, D) after rotary when ``return_kv``.
    mode="flash" (default): the flash kernel (``models.flash``); any
    other mode: ``chunked_attention``, the reference softmax path."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, xkv)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta, _sections(cfg))
        k = L.apply_rope(k, positions, cfg.rope_theta, _sections(cfg))
    if mode == "flash":
        o = flash_attention(q, k, v, causal=causal, window=window)
    else:
        o = chunked_attention(q, k, v, causal=causal, window=window)
    out = _out_proj(p, cfg, o.reshape(B, S, -1))
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p: dict, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                     window: int = 0, rope: bool = True, rope_pos=None):
    """Single-token decode against a contiguous cache.

    x: (B, 1, d).  cache_k/cache_v: (B, S_cache, Hkv, D), the layer's
    view of the cache, written in place; S_cache is the ring length
    ``min(max_seq, window)`` for sliding-window archs, else max_seq.
    pos: an int or 0-d tensor (every sequence at the same position: the
    fixed-slot engine) or a (B,) int32 tensor of per-sequence positions
    (continuous batching).  The new k/v land at ``pos`` (``pos %
    S_cache`` in a ring buffer) and attention covers ``min(pos + 1,
    S_cache)`` positions: a ring holds an unordered window, and softmax
    is order-invariant, so masking by validity is the whole job (rotary
    already encoded the order).  ``rope=False`` skips the rotary
    embedding (whisper); ``rope_pos`` is the rotary position where it
    is not the cache slot (Qwen2-VL: text positions restart after the
    patch grid), broadcast to (3, B, 1) for M-RoPE.  Returns (out,
    cache_k, cache_v).

    Under a mesh the cache is the rank's slice by the reference's rule
    (``sharding.shard_cache``).  Where it holds more KV heads than the
    rank's weights compute, the heads' q, k and v are gathered (one
    exact gather).  Where its positions are cut over the "seq" axes
    (``pspec.cache_seq``: the step resolves them once), the rank at
    index i holds slots ``[i * S_loc, (i + 1) * S_loc)`` of the cache
    (or of the ring): only the rank that owns slot ``pos`` writes the new
    k/v, each rank runs the decode kernel on its valid slots
    ``clamp(kv_len - i * S_loc, 0, S_loc)`` with the log-sum-exp, and the
    ranks' partials meet in one exact gather over those axes, merged in
    rank order on every rank (``merge_partials``), so all ranks hold the
    same bits."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    posv = pos.reshape(-1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x)
    if rope:
        rp = posv if rope_pos is None else torch.as_tensor(
            rope_pos, dtype=torch.int32, device=x.device).reshape(-1, 1) \
            .expand(B, 1)
        if cfg.mrope:
            rp = rp[None].expand(3, B, 1)
        q = L.apply_rope(q, rp, cfg.rope_theta, _sections(cfg))
        k = L.apply_rope(k, rp, cfg.rope_theta, _sections(cfg))
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    H_w = q.shape[1]
    heads = None
    if k.shape[1] != cache_k.shape[2]:       # the cache holds every head
        heads = L.tp_axis(k.shape[1], cache_k.shape[2])
        q, k, v = _gather_heads(heads, q, k, v)
    S_loc = cache_k.shape[1]
    seq = PS.cache_seq()
    i0, S_cache = 0, S_loc
    if seq is not None:
        mesh = PS.current_mesh()
        i0, S_cache = mesh.index(seq) * S_loc, S_loc * PS.entry_size(seq)
    slot = (posv[:, 0] % S_cache if window else posv[:, 0]).long()
    rows = torch.arange(B, device=x.device)
    kv_len = torch.clamp(posv[:, 0] + 1, max=S_cache).to(torch.int32)
    if seq is None:
        cache_k[rows, slot] = k.to(cache_k.dtype)
        cache_v[rows, slot] = v.to(cache_v.dtype)
        o = ops.decode_attention(q, cache_k, cache_v, kv_len)
    else:
        local = slot - i0
        mine = ((local >= 0) & (local < S_loc))[:, None, None]
        at = local.clamp(0, S_loc - 1)
        cache_k[rows, at] = torch.where(mine, k.to(cache_k.dtype),
                                        cache_k[rows, at])
        cache_v[rows, at] = torch.where(mine, v.to(cache_v.dtype),
                                        cache_v[rows, at])
        n_loc = torch.clamp(kv_len - i0, 0, S_loc).to(torch.int32)
        o, lse = ops.decode_attention(q, cache_k, cache_v, n_loc,
                                      return_lse=True)
        o = merge_partials(o, lse, mesh, seq)
    if heads is not None:                    # back to the rank's heads
        mesh, ax = heads
        o = o.narrow(1, mesh.index(ax) * H_w, H_w)
    out = _out_proj(p, cfg, o.reshape(B, 1, -1))
    return out, cache_k, cache_v


def _gather_heads(heads, q, k, v):
    """Every head's q, k and v (B, heads, D) from each rank's, by one
    exact gather over the heads' axes ``heads`` = (mesh, axes): a rank's
    heads are a block, in the axes' order."""
    mesh, ax = heads
    B, Hq, D = q.shape
    Hk = k.shape[1]
    every = mesh.gather(torch.cat([q, k, v], dim=1)[:, None], 1, ax)
    return (every[:, :, :Hq].reshape(B, -1, D),
            every[:, :, Hq:Hq + Hk].reshape(B, -1, D),
            every[:, :, Hq + Hk:].reshape(B, -1, D))


def merge_partials(o, lse, mesh, axes):
    """The attention of every rank's positions from each rank's partial
    over its own: ``o`` (B, H, D) normalized over the rank's positions,
    ``lse`` (B, H) fp32 their log-sum-exp (-1e30 where the rank holds
    none, with ``o`` 0).  One exact gather of (B, H, D + 1) fp32 over
    ``axes``; each rank then weighs the parts by exp(lse - max) in rank
    order, so every rank holds the same bits.  Returns o's type."""
    part = torch.cat([o.to(F32), lse[..., None]], dim=-1)
    every = mesh.gather(part[None], 0, axes)              # (n, B, H, D+1)
    o_r, l_r = every[..., :-1], every[..., -1]
    w = torch.exp(l_r - l_r.max(dim=0).values)
    return ((w[..., None] * o_r).sum(0) / w.sum(0)[..., None]).to(o.dtype)


def _chunk_page_targets(pos_offset: int, C: int, n_valid: int,
                        page_size: int, block_table: torch.Tensor):
    """Scatter targets for one prefill chunk: position ``pos_offset + i``
    lands in page ``bt[pos // page_size]`` at offset ``pos % page_size``;
    pad positions (``i >= n_valid``: chunk widths are bucketed) land on
    the scratch page 0, which no live sequence reads."""
    dev = block_table.device
    pos = pos_offset + torch.arange(C, dtype=torch.int64, device=dev)
    valid = torch.arange(C, device=dev) < n_valid
    flat = block_table.reshape(-1).long()
    # pad positions may run past the table's end: clamp like a JAX gather
    idx = (pos // page_size).clamp(max=flat.numel() - 1)
    page = torch.where(valid, flat[idx], 0)
    return pos, page, pos % page_size


def paged_prefill_attention(p: dict, cfg: ModelConfig, x, pool_k, pool_v,
                            pos_offset: int, n_valid: int, block_tables, *,
                            window: int = 0):
    """One prompt chunk of a single sequence, straight into the paged KV
    pool.  x: (1, C, d) activations of positions ``pos_offset ..
    pos_offset + C`` (the first ``n_valid`` real, the rest bucket pads).
    pool_k/pool_v: (n_pages, page_size, Hkv, D), written in place.
    block_tables: (1, max_pages) int32 covering at least positions
    [0, pos_offset + n_valid).  Every chunk position's output is exact
    (speculative verify reads them all).  Returns (out, pool_k, pool_v).
    """
    B, C, _ = x.shape
    ps = pool_k.shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    pos, page, off = _chunk_page_targets(pos_offset, C, n_valid, ps,
                                         block_tables)
    posv = pos[None].expand(B, C)
    q = L.apply_rope(q, posv, cfg.rope_theta)
    k = L.apply_rope(k, posv, cfg.rope_theta)
    pool_k[page, off] = k[0].to(pool_k.dtype)
    pool_v[page, off] = v[0].to(pool_v.dtype)
    bt = block_tables.reshape(-1).long()
    kg = pool_k[bt].reshape(1, -1, *pool_k.shape[2:])
    vg = pool_v[bt].reshape(1, -1, *pool_v.shape[2:])
    o = chunked_attention(q, kg, vg, causal=True, q_offset=pos_offset,
                          window=window, kv_len=pos_offset + n_valid)
    out = _out_proj(p, cfg, o.reshape(B, C, -1))
    return out, pool_k, pool_v


def paged_attention_decode(p: dict, cfg: ModelConfig, x, pool_k, pool_v,
                           pos, block_tables, *, window: int = 0):
    """Single-token decode against a paged KV pool.

    x: (B, 1, d).  pool_k/pool_v: (n_pages, page_size, Hkv, D), the
    layer's slice of the pool, written in place.  pos: (B,) int32
    absolute write positions.  block_tables: (B, max_pages) int32; unused
    entries (and whole rows of idle slots) point at the scratch page 0.

    The new k/v land in page ``bt[b, pos // page_size]`` at offset
    ``pos % page_size``.  On a CUDA pool with full attention the
    hand-written paged decode kernel reads the pages through the tables;
    otherwise (a CPU pool, or a sliding window) the tables are gathered
    back into position order and masked to ``pos + 1`` valid positions
    (lower-bounded at ``pos + 1 - window`` for sliding-window archs)."""
    B = x.shape[0]
    ps = pool_k.shape[1]
    q, k, v = _project_qkv(p, cfg, x)
    posv = pos.reshape(B, 1)
    q = L.apply_rope(q, posv, cfg.rope_theta)
    k = L.apply_rope(k, posv, cfg.rope_theta)
    page = block_tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
    off = pos.long() % ps
    pool_k[page, off] = k[:, 0].to(pool_k.dtype)
    pool_v[page, off] = v[:, 0].to(pool_v.dtype)
    kv_len = (pos + 1).to(torch.int32)
    if window == 0 and pool_k.is_cuda:
        o = ops.paged_decode_attention(q[:, 0], pool_k, pool_v,
                                       block_tables, kv_len)[:, None]
    else:
        bt = block_tables.long()
        kg = pool_k[bt].reshape(B, -1, *pool_k.shape[2:])
        vg = pool_v[bt].reshape(B, -1, *pool_v.shape[2:])
        kv_start = (pos + 1 - window).clamp_min(0) if window else None
        o = chunked_attention(q, kg, vg, causal=False, kv_len=kv_len,
                              kv_start=kv_start)
    out = _out_proj(p, cfg, o.reshape(B, 1, -1))
    return out, pool_k, pool_v


# --------------------------------------------------------------------------
# MLA (DeepSeek-V3): expanded for the monolithic prefill, absorbed for
# chunked prefill and decode
# --------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen, device, lead=()) -> dict:
    """DeepSeek-V3 Multi-head Latent Attention params [arXiv:2412.19437]
    with leading stack axes ``lead``, drawn in the reference's order."""
    m = cfg.mla
    dt = L.dtype_of(cfg.param_dtype)
    d, H = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim

    def dense(shape):
        return L.dense_init((*lead, *shape), dt, gen, device)
    return {
        "w_dq": dense((d, m.q_lora_rank)),
        "q_norm": L.init_rmsnorm(m.q_lora_rank, dt, device, lead),
        "w_uq": dense((m.q_lora_rank, H * qk_head)),
        # down-projection to the compressed latent + the shared rope key
        "w_dkv": dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": L.init_rmsnorm(m.kv_lora_rank, dt, device, lead),
        # up-projections from the latent: k_nope and v per head
        "w_uk": dense((m.kv_lora_rank, H * m.qk_nope_head_dim)),
        "w_uv": dense((m.kv_lora_rank, H * m.v_head_dim)),
        "w_o": dense((H * m.v_head_dim, d)),
    }


def _mla_qkv(p, cfg, x, positions):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope) after rotary, the
    normed latent ckv (B,S,r), k_rope (B,S,rope) after rotary)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    ql = L.rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = (ql @ p["w_uq"]).reshape(B, S, H, qk_head)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta)
    dkv = x @ p["w_dkv"]
    ckv, k_rope = dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    ckv = L.rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope[:, :, 0, :]


def mla_fwd(p: dict, cfg: ModelConfig, x, positions, *, mode="flash",
            return_cache: bool = False):
    """Expanded MLA over a full sequence: per-head k/v rebuilt from the
    latent, attention through the flash kernel at q/k head dim
    ``qk_nope + qk_rope`` and v head dim ``v_head_dim`` (softmax scale
    of the q/k dim).  Returns out, or (out, (ckv, k_rope)) — the latent
    cache leaves — with ``return_cache``.  Under a mesh whose ``w_uk``
    and ``w_uv`` hold the rank's rows of the latent rank, k and v of
    every head are partial sums joined over "model", and every rank
    runs attention over all heads."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, positions)
    r_loc, r = p["w_uk"].shape[-2], m.kv_lora_rank
    # under a mesh the up-projections hold this rank's rows of the latent
    # rank: partial k and v of every head, summed over its axes
    c = ckv if r_loc == r else _rank_cols(
        L.to_model(ckv, L.tp_axis(r_loc, r)[1]), r_loc)
    k_nope = L.tp_sum(c @ p["w_uk"], r_loc, r).reshape(
        B, S, H, m.qk_nope_head_dim)
    v = L.tp_sum(c @ p["w_uv"], r_loc, r).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = (flash_attention(q, k, v, causal=True) if mode == "flash"
         else chunked_attention(q, k, v, causal=True))
    out = o.reshape(B, S, -1) @ p["w_o"]
    if return_cache:
        return out, (ckv, k_rope)
    return out


def _rank_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """This rank's ``width`` columns of ``t``'s last axis when a pool
    leaf that wide holds the rank's slice of it (``launch.sharding``);
    ``t`` itself when the leaf is whole."""
    if t.shape[-1] == width:
        return t
    mesh, axis = L.tp_axis(width, t.shape[-1])
    rank = mesh.index(axis)
    return t[..., rank * width:(rank + 1) * width]


def _mla_absorbed_attend(p, cfg, q_nope, q_rope, ckv_seq, krope_seq, valid):
    """Absorbed MLA attention core, in fp32 [arXiv:2412.19437 §2.1.1]:
    the k up-projection folded into the query and the v up-projection
    into the output, so attention runs in the latent space.
    q_nope/q_rope: (B,Sq,H,*); ckv_seq: (B,S,r); krope_seq: (B,S,rope);
    valid: (B,S) bool (every query) or (B,Sq,S) per query.  Returns the
    per-head context (B, Sq, H*v_head_dim) in fp32.

    Under a mesh ``ckv_seq`` (with ``w_uk``/``w_uv``'s rows) and
    ``krope_seq`` may hold this rank's slice of the latent rank and of
    the rotary width: each contraction over a cut width is a partial
    sum, and the partial scores meet in one all-reduce before the
    softmax, the partial outputs in one after the value
    up-projection."""
    m = cfg.mla
    H = cfg.n_heads
    B, Sq = q_nope.shape[:2]
    r_loc, rope_loc = ckv_seq.shape[-1], krope_seq.shape[-1]
    lat_cut = r_loc != m.kv_lora_rank
    rope_cut = rope_loc != m.qk_rope_head_dim
    mesh = PS.current_mesh()
    # the axes of each cut ("model", or under infer-tp2 both axes or
    # "data": the rank and the rotary width may divide differently)
    ax_lat = L.tp_axis(r_loc, m.kv_lora_rank)[1] if lat_cut else None
    ax_rope = (L.tp_axis(rope_loc, m.qk_rope_head_dim)[1] if rope_cut
               else None)
    q_rope = _rank_cols(q_rope, rope_loc)
    w_uk = p["w_uk"].reshape(r_loc, H, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.to(F32), w_uk.to(F32))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_seq.to(F32))
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.to(F32),
                          krope_seq.to(F32))
    if lat_cut and ax_lat == ax_rope:
        s = mesh.all_reduce(s_lat + s_rope, ax_lat)
    else:
        if lat_cut:
            s_lat = mesh.all_reduce(s_lat, ax_lat)
        if rope_cut:
            s_rope = mesh.all_reduce(s_rope, ax_rope)
        s = s_lat + s_rope
    s = s * scale
    mask = (valid[:, None, None, :] if valid.dim() == 2
            else valid[:, None, :, :])
    s = torch.where(mask, s, NEG_INF)
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", prob, ckv_seq.to(F32))
    w_uv = p["w_uv"].reshape(r_loc, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.to(F32))
    if lat_cut:
        o = mesh.all_reduce(o, ax_lat)
    return o.reshape(B, Sq, -1)


def mla_decode(p: dict, cfg: ModelConfig, x, cache_ckv, cache_krope, pos):
    """Absorbed MLA decode against a contiguous latent cache.  x:
    (B, 1, d); cache_ckv (B, S, r) and cache_krope (B, S, rope), written
    in place at ``pos``: an int or 0-d tensor (the fixed-slot engine) or
    a (B,) tensor of per-sequence positions.  Attention covers positions
    ``<= pos``.  Under a mesh the leaves hold the rank's columns of the
    latent rank and rotary width (the reference's rule), which it
    writes.  Returns (out, cache_ckv, cache_krope)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    posv = pos.reshape(-1, 1).expand(B, 1)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, posv)
    rows = torch.arange(B, device=x.device)
    slot = posv[:, 0].long()
    cache_ckv[rows, slot] = _rank_cols(ckv[:, 0], cache_ckv.shape[-1]) \
        .to(cache_ckv.dtype)
    cache_krope[rows, slot] = _rank_cols(k_rope[:, 0],
                                         cache_krope.shape[-1]) \
        .to(cache_krope.dtype)
    kv_pos = torch.arange(cache_ckv.shape[1], device=x.device)
    valid = kv_pos[None, :] <= posv                          # (B, S)
    out = _mla_absorbed_attend(p, cfg, q_nope, q_rope, cache_ckv,
                               cache_krope, valid).to(x.dtype)
    return out @ p["w_o"], cache_ckv, cache_krope


def mla_paged_prefill(p: dict, cfg: ModelConfig, x, pool_ckv, pool_krope,
                      pos_offset: int, n_valid: int, block_tables):
    """One prompt chunk straight into the paged latent pool (see
    ``paged_prefill_attention`` for the chunk and page layout): the
    chunk's (ckv, k_rope) land in their absolute-position pages, pads on
    the scratch page, and attention is the absorbed path with a
    per-query causal mask; every chunk position's output is exact."""
    B, C, _ = x.shape
    ps = pool_ckv.shape[1]
    pos, page, off = _chunk_page_targets(pos_offset, C, n_valid, ps,
                                         block_tables)
    posv = pos[None].expand(B, C)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, posv)
    pool_ckv[page, off] = _rank_cols(ckv[0], pool_ckv.shape[-1]) \
        .to(pool_ckv.dtype)
    pool_krope[page, off] = _rank_cols(k_rope[0], pool_krope.shape[-1]) \
        .to(pool_krope.dtype)
    bt = block_tables.reshape(-1).long()
    ckv_seq = pool_ckv[bt].reshape(1, -1, pool_ckv.shape[-1])
    krope_seq = pool_krope[bt].reshape(1, -1, pool_krope.shape[-1])
    kv_pos = torch.arange(ckv_seq.shape[1], device=x.device)
    valid = ((kv_pos[None, None, :] <= pos[None, :, None])
             & (kv_pos[None, None, :] < pos_offset + n_valid))
    out = _mla_absorbed_attend(p, cfg, q_nope, q_rope, ckv_seq,
                               krope_seq, valid).to(x.dtype)
    return out @ p["w_o"], pool_ckv, pool_krope


def mla_paged_decode(p: dict, cfg: ModelConfig, x, pool_ckv, pool_krope,
                     pos, block_tables):
    """Absorbed MLA decode against a paged latent pool: pool_ckv
    (n_pages, page_size, r), pool_krope (n_pages, page_size, rope),
    written in place; pos (B,) int32 absolute write positions;
    block_tables (B, max_pages) int32 (see ``paged_attention_decode``).
    Plain PyTorch, as the reference's is plain jnp."""
    B = x.shape[0]
    ps = pool_ckv.shape[1]
    posv = pos.reshape(B, 1)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, posv)
    page = block_tables.long().gather(1, (pos.long() // ps)[:, None])[:, 0]
    off = pos.long() % ps
    pool_ckv[page, off] = _rank_cols(ckv[:, 0], pool_ckv.shape[-1]) \
        .to(pool_ckv.dtype)
    pool_krope[page, off] = _rank_cols(k_rope[:, 0], pool_krope.shape[-1]) \
        .to(pool_krope.dtype)
    bt = block_tables.long()
    ckv_seq = pool_ckv[bt].reshape(B, -1, pool_ckv.shape[-1])
    krope_seq = pool_krope[bt].reshape(B, -1, pool_krope.shape[-1])
    kv_pos = torch.arange(ckv_seq.shape[1], device=x.device)
    valid = kv_pos[None, :] <= pos[:, None]
    out = _mla_absorbed_attend(p, cfg, q_nope, q_rope, ckv_seq,
                               krope_seq, valid).to(x.dtype)
    return out @ p["w_o"], pool_ckv, pool_krope
