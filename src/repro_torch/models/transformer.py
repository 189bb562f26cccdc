"""Model assembly for the dense, moe (qwen3-moe; deepseek-v3 with MLA),
hybrid (zamba2) and ssm (xLSTM) families: the twin of the JAX package's
``models/transformer.py`` on the serving and training paths.

    params          = init_params(cfg, seed=0, device="cuda")
    # contiguous cache (fixed-slot engine, contiguous SlotManager)
    cache           = init_cache(cfg, B, max_seq, device)
    logits, _, pcache = forward(params, cfg, {"tokens": t},
                                return_cache=True)
    cache           = graft_slot_cache(cache, pcache, slot)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos)
    # paged pool (continuous engine, dense and moe)
    cache           = init_paged_cache(cfg, n_pages, page_size, device)
    logits, _, cache = prefill_chunk(params, cfg, cache, tokens, n_valid,
                                     pos_offset, block_tables)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos,
                                  block_tables=block_tables)
    snap            = extract_paged_cache(cache, page_ids, since)  # spill
    cache           = graft_paged_cache(cache, snap, new_ids)      # resume
    cache           = copy_paged_pages(cache, src_ids, dst_ids)    # CoW
    # training (every ported family)
    loss, metrics   = loss_fn(params, cfg, {"tokens": t})

Params keep the JAX tree paths (dense: ``embed``, ``final_norm/scale``,
``blocks/{ln1,attn,ln2,mlp}/...`` with a leading layer axis; moe:
``blocks_dense`` (the leading dense-MLP layers, if any) and
``blocks_moe/{...,moe}/...``, MLA leaves under ``attn`` for deepseek,
and ``mtp``; hybrid: ``mamba_units/...`` with leading (units, k_every)
axes, ``mamba_tail``, ``shared_attn`` and ``shared_adapters``; ssm:
``mlstm_units/...`` with leading (units, slstm_every - 1) axes and
``slstm_units/...`` with a leading (units,) axis), so
``repro_torch.bridge`` maps a JAX params tree leaf for leaf.  The KV
trees follow the same stacks; MLA caches hold the latent ``ckv`` and
the rotary key ``krope`` instead of ``k`` and ``v``.  The
``jax.lax.scan`` over layers is a Python loop over views of the
stacked tensors.  Caches and pools are
updated in place (see ``models.attention``).  ``prefill``,
``decode_step`` and ``prefill_chunk`` run under ``torch.no_grad()``;
``forward`` records an autograd graph when the caller's grad mode and
params ask for one (``loss_fn``), so every serving caller runs it under
``torch.no_grad()``.  Under autograd each attention block is
recomputed in the backward (``remat``, the twin of ``jax.checkpoint``;
so is each Mamba2, mLSTM and sLSTM block), flash attention takes the
reference's flash backward (``models.flash``) and the SSD scan the
plain scan's (``models.ssm.SSDChunkScan``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X

F32 = torch.float32
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm")
# the paged KV pool (and the chunked prefill and decode that read it) is
# for the attention families: recurrent state is fixed-size per slot and
# stays contiguous, as in the reference
PAGED_FAMILIES = ("dense", "moe")


def require_ported(cfg: ModelConfig, what: str) -> None:
    """Raise for a family the port does not serve yet (audio, vlm)."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet "
            f"({' and '.join(PORTED_FAMILIES)} only)")


def require_paged(cfg: ModelConfig, what: str) -> None:
    """Raise for a family with no paged KV cache (the recurrent families,
    hybrid and ssm)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"{what}: no paged KV cache for family {cfg.family!r} "
            "(recurrent families keep their fixed-size state path)")


def _hybrid_layout(cfg: ModelConfig):
    """(units, k_every, tail) of a zamba2 stack: ``units`` of k_every
    Mamba2 blocks each followed by the shared attention block, then
    ``tail`` more Mamba2 blocks."""
    k = cfg.shared_attn_every
    units, tail = divmod(cfg.n_layers, k)
    return units, k, tail


def _xlstm_layout(cfg: ModelConfig):
    """(units, per) of an xLSTM stack: ``units`` of ``per`` mLSTM blocks
    each followed by one sLSTM block (the reference's 7:1 ratio at
    slstm_every = 8)."""
    k = cfg.xlstm.slstm_every
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"whole number of {k}-block xLSTM units")
    return cfg.n_layers // k, k - 1


def attn_stacks(cfg: ModelConfig) -> tuple:
    """(name, layers) of the attention stacks of a dense or moe config,
    in order: dense ``blocks``; moe ``blocks_dense`` (its leading dense-
    MLP layers, when it has any) then ``blocks_moe``."""
    if cfg.family == "dense":
        return (("blocks", cfg.n_layers),)
    nd = cfg.moe.n_dense_layers
    return ((("blocks_dense", nd),) if nd else ()) + (
        ("blocks_moe", cfg.n_layers - nd),)


# ==========================================================================
# init
# ==========================================================================

def _init_attn_block(cfg: ModelConfig, gen, dev, lead=(), d_in=None,
                     use_moe: bool = False, dense_ff=None) -> dict:
    """Pre-norm attention + MLP block params with leading stack axes
    ``lead``: GQA attention, or MLA when the config has it; then the
    MoE MLP (``use_moe``), or a SwiGLU (the biased GELU MLP for
    ``mlp_type="gelu"``) of width ``dense_ff or d_ff``.  ``d_in`` widens
    ln1 and the q/k/v projections (zamba2's shared block reads
    concat(hidden, embedding), 2 * d_model)."""
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p = {"ln1": L.init_rmsnorm(d_in or d, dt, dev, lead)}
    p["attn"] = (A.init_mla(cfg, gen, dev, lead) if cfg.mla is not None
                 else A.init_attention(cfg, gen, dev, lead, d_in=d_in))
    p["ln2"] = L.init_rmsnorm(d, dt, dev, lead)
    if use_moe:
        p["moe"] = M.init_moe(cfg, gen, dev, lead)
        return p
    init_mlp = L.init_gelu_mlp if cfg.mlp_type == "gelu" else L.init_swiglu
    p["mlp"] = init_mlp(gen, d, dense_ff or cfg.d_ff, dt, dev, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random params in the JAX package's layout, drawn from a seeded
    ``torch.Generator`` on ``device`` (they are NOT the JAX package's
    numbers: parity tests load those through ``bridge``)."""
    require_ported(cfg, "init_params")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
                  * 0.02).to(dt),
        "final_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
    }
    if cfg.family == "dense":
        p["blocks"] = _init_attn_block(cfg, gen, dev, lead=(cfg.n_layers,))
    elif cfg.family == "moe":
        m = cfg.moe
        if m.n_dense_layers:
            p["blocks_dense"] = _init_attn_block(
                cfg, gen, dev, lead=(m.n_dense_layers,),
                dense_ff=m.dense_d_ff)
        p["blocks_moe"] = _init_attn_block(
            cfg, gen, dev, lead=(cfg.n_layers - m.n_dense_layers,),
            use_moe=True)
    elif cfg.family == "ssm":
        units, per = _xlstm_layout(cfg)
        p["mlstm_units"] = X.init_mlstm_block(cfg, gen, dev, lead=(units, per))
        p["slstm_units"] = X.init_slstm_block(cfg, gen, dev, lead=(units,))
    else:
        units, k, tail = _hybrid_layout(cfg)
        p["mamba_units"] = SSM.init_mamba2(cfg, gen, dev, lead=(units, k))
        if tail:
            p["mamba_tail"] = SSM.init_mamba2(cfg, gen, dev, lead=(tail,))
        # one weight-shared attention block over concat(h, emb) -> 2d
        p["shared_attn"] = _init_attn_block(cfg, gen, dev, d_in=2 * d)
        # per-application output adapters; the reference's dense_init
        # takes shape[0] (units) as their fan-in, with scale 0.1
        p["shared_adapters"] = L.dense_init((units, d, d), dt, gen, dev,
                                            scale=0.1, fan_in=units)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init((d, cfg.vocab_size), dt, gen, dev)
    if cfg.use_mtp:
        # DeepSeek-V3's multi-token prediction module [arXiv:2412.19437
        # §2.2]: the trunk's hidden state with the NEXT token's
        # embedding, one extra block, the shared unembedding
        # (``mtp_logits``; trained by ``loss_fn``)
        m = cfg.moe
        p["mtp"] = {
            "norm_h": L.init_rmsnorm(d, dt, dev),
            "norm_e": L.init_rmsnorm(d, dt, dev),
            "proj": L.dense_init((2 * d, d), dt, gen, dev),
            "block": _init_attn_block(
                cfg, gen, dev, dense_ff=(m.dense_d_ff if m and m.dense_d_ff
                                         else cfg.d_ff)),
            "final_norm": L.init_rmsnorm(d, dt, dev)}
    return p


def layer_params(stacked: dict, *idx) -> dict:
    """The params at index ``idx`` of the leading stack axes, as views
    into the stacked tensors."""
    return {k: layer_params(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in stacked.items()}


def _unbind_params(stacked: dict, n: int) -> list:
    """The ``n`` per-layer param dicts of a stack (leading axis ``n``),
    from one ``torch.unbind`` per leaf.  Under autograd the stacked
    gradient is then one stack of the layers' gradients; indexing each
    layer (``layer_params``) would add a zero-filled, stack-sized
    gradient per layer, n times the stack's bytes."""
    per = {k: (_unbind_params(v, n) if isinstance(v, dict)
               else torch.unbind(v)) for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _stack_layers(stacked: dict, lead) -> list:
    """The per-layer param dicts of a stack with leading axes ``lead``
    (one axis, or (units, per)): a list, or a list of lists, by
    ``_unbind_params``."""
    layers = _unbind_params(stacked, lead[0])
    if len(lead) == 1:
        return layers
    return [_unbind_params(u, lead[1]) for u in layers]


def _attn_cache(cfg: ModelConfig, n: int, B: int, max_seq: int, dt, dev):
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros((n, B, max_seq, m.kv_lora_rank),
                                   dtype=dt, device=dev),
                "krope": torch.zeros((n, B, max_seq, m.qk_rope_head_dim),
                                     dtype=dt, device=dev)}
    S_c = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
           else max_seq)
    shape = (n, B, S_c, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _mamba_cache(cfg: ModelConfig, lead, B: int, dt, dev):
    s = cfg.ssm
    d_inner, nh = SSM._dims(cfg)
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {"ssm": torch.zeros((*lead, B, nh, s.head_dim, s.d_state),
                               dtype=F32, device=dev),
            "conv": torch.zeros((*lead, B, s.d_conv - 1, conv_ch), dtype=dt,
                                device=dev)}


def _xlstm_cache(cfg: ModelConfig, B: int, dt, dev):
    xl = cfg.xlstm
    units, per = _xlstm_layout(cfg)
    d_inner, nh, dh = X.mlstm_dims(cfg)
    d = cfg.d_model
    nh_s, dh_s = cfg.n_heads, d // cfg.n_heads

    def full(shape, value, dtype=F32):
        return torch.full(shape, value, dtype=dtype, device=dev)
    return {
        "mlstm_units": {
            "C": full((units, per, B, nh, dh, dh), 0.0),
            "n": full((units, per, B, nh, dh), 0.0),
            "m": full((units, per, B, nh), -1e30),
            "conv": full((units, per, B, xl.d_conv - 1, d_inner), 0.0, dt)},
        "slstm_units": {
            "h": full((units, B, d), 0.0),
            "c": full((units, B, nh_s, dh_s), 0.0),
            "n": full((units, B, nh_s, dh_s), 1e-6),
            "m": full((units, B, nh_s, dh_s), 0.0),
            "conv_win": full((units, B, xl.d_conv - 1, d), 0.0, dt)}}


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cuda") -> dict:
    """Zero contiguous cache.  Dense: ``{"blocks": {"k", "v"}}`` with
    leaves (L, B, S_cache, Hkv, D) in the activation dtype (S_cache is
    max_seq, or the ring length ``min(max_seq, sliding_window)``).  Moe:
    the same per stack (``blocks_dense``, ``blocks_moe``); with MLA each
    stack holds ``ckv`` (L, B, max_seq, kv_lora_rank) and ``krope``
    (L, B, max_seq, qk_rope_head_dim) instead.  Hybrid: ``mamba_units``
    {"ssm" (units, k, B, H, P, N) fp32, "conv" (units, k, B, d_conv-1,
    conv_ch)}, ``shared_attn`` {"k", "v"} with
    ONE K/V stack per unit (units, B, S_cache, Hkv, D), and
    ``mamba_tail`` {"ssm", "conv"} with a leading (tail,) axis.  Ssm:
    ``mlstm_units`` {"C" (units, per, B, H, dh, dh), "n" (.., H, dh), "m"
    (.., H) at -1e30, all fp32, "conv" (.., d_conv-1, d_inner)} and
    ``slstm_units`` {"h" (units, B, d), "c", "n" (at 1e-6), "m" (units,
    B, H, d/H) fp32, "conv_win" (units, B, d_conv-1, d)}: no sequence
    axis, so ``max_seq`` is unused."""
    require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.activation_dtype)
    if cfg.family == "ssm":
        return _xlstm_cache(cfg, B, dt, dev)
    if cfg.family != "hybrid":
        return {name: _attn_cache(cfg, n, B, max_seq, dt, dev)
                for name, n in attn_stacks(cfg)}
    units, k, tail = _hybrid_layout(cfg)
    c = {"mamba_units": _mamba_cache(cfg, (units, k), B, dt, dev),
         "shared_attn": _attn_cache(cfg, units, B, max_seq, dt, dev)}
    if tail:
        c["mamba_tail"] = _mamba_cache(cfg, (tail,), B, dt, dev)
    return c


def _batch_axis_slices(big: torch.Tensor, small_shape, slot: int):
    """Index of the region ``small_shape`` covers in ``big`` at ``slot``:
    the batch axis is the first axis where the shapes differ (axis 1 of
    an attention stack's, a tail or an ``slstm_units`` leaf, axis 2 of a
    ``mamba_units`` or an ``mlstm_units`` leaf), and any later mismatch
    (the shorter sequence axis) starts at 0."""
    idx = []
    found = False
    for a, b in zip(big.shape, small_shape):
        if a != b and not found:
            idx.append(slice(slot, slot + b))
            found = True
        else:
            idx.append(slice(0, b))
    return tuple(idx)


def graft_slot_cache(cache: dict, prefix_cache: dict, slot: int) -> dict:
    """Write a single-sequence prefix cache (batch axis of size 1) into
    slot ``slot`` of a multi-slot cache, leaf by leaf and in place.
    Stale cache beyond the prefix stays and must be masked by the
    caller's per-slot lengths until overwritten."""
    for name, sub in cache.items():
        for leaf, big in sub.items():
            small = prefix_cache[name][leaf]
            big[_batch_axis_slices(big, small.shape, slot)] = \
                small.to(big.dtype)
    return cache


def extract_slot_cache(cache: dict, template: dict, slot: int) -> dict:
    """Slot ``slot`` of a multi-slot cache as a new single-sequence cache
    shaped like ``template`` (a batch-1 cache from ``init_cache``): the
    inverse of ``graft_slot_cache``."""
    return {name: {leaf: big[_batch_axis_slices(
                big, template[name][leaf].shape, slot)].clone()
                   for leaf, big in sub.items()}
            for name, sub in cache.items()}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device="cuda") -> dict:
    """Zero paged KV pool in the activation dtype, one entry per
    attention stack (``attn_stacks``): ``{"k", "v"}`` with leaves
    (L, n_pages, page_size, Hkv, D), or for MLA ``{"ckv", "krope"}``
    with leaves (L, n_pages, page_size, kv_lora_rank / qk_rope_head_dim).
    Page 0 is the scratch page.  Which sequence owns which page lives in
    the engine's block tables.  Dense and moe only: recurrent state
    (hybrid) is fixed-size per slot and keeps the contiguous layout, as
    in the reference."""
    require_ported(cfg, "init_paged_cache")
    require_paged(cfg, "init_paged_cache")
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.activation_dtype)
    if cfg.mla is not None:
        m = cfg.mla
        widths = {"ckv": (m.kv_lora_rank,), "krope": (m.qk_rope_head_dim,)}
    else:
        hd = (cfg.n_kv_heads, cfg.resolved_head_dim)
        widths = {"k": hd, "v": hd}
    return {name: {leaf: torch.zeros((n, n_pages, page_size, *w), dtype=dt,
                                     device=dev)
                   for leaf, w in widths.items()}
            for name, n in attn_stacks(cfg)}


def _page_index(page_ids, since: int, device) -> torch.Tensor:
    ids = torch.as_tensor(page_ids, dtype=torch.long)
    return ids[since:].to(device)


def graft_paged_cache(cache: dict, prefix_cache: dict, page_ids,
                      since: int = 0) -> dict:
    """Scatter a single-sequence prefix cache (leaves (L, 1, S_b, ...),
    on any device) into pages ``page_ids`` ((n0,) ints) of the paged
    pool, in place.  The prefix is padded or clamped to ``n0 *
    page_size`` positions, so every written page is fully overwritten;
    positions past the true length stay masked by the per-slot
    ``kv_len``.  ``since`` skips the first ``since`` entries of
    ``page_ids`` (the delta half of a KV-delta spill).  Returns the
    cache."""
    for name, sub in cache.items():
        for leaf, pool in sub.items():
            ids = _page_index(page_ids, since, pool.device)
            ps, n0 = pool.shape[2], ids.shape[0]
            sm = prefix_cache[name][leaf][:, 0]           # (L, S_b, ...)
            sm = sm.to(device=pool.device, dtype=pool.dtype)
            if sm.shape[1] < n0 * ps:
                pad = torch.zeros((sm.shape[0], n0 * ps - sm.shape[1],
                                   *sm.shape[2:]), dtype=sm.dtype,
                                  device=sm.device)
                sm = torch.cat([sm, pad], dim=1)
            sm = sm[:, :n0 * ps].reshape(sm.shape[0], n0, ps, *sm.shape[2:])
            pool[:, ids] = sm
    return cache


def extract_paged_cache(cache: dict, page_ids, since: int = 0) -> dict:
    """Gather pages ``page_ids[since:]`` of the paged pool into a new
    single-sequence prefix cache (leaves (L, 1, n * page_size, ...) on
    the pool's device): the exact inverse of ``graft_paged_cache``.  The
    snapshot is a whole number of pages, so a graft pads nothing and the
    round trip is bit-exact."""
    out = {}
    for name, sub in cache.items():
        out[name] = {}
        for leaf, pool in sub.items():
            sm = pool[:, _page_index(page_ids, since, pool.device)]
            L_, n, ps = sm.shape[:3]
            out[name][leaf] = sm.reshape(L_, 1, n * ps, *sm.shape[3:])
    return out


def copy_paged_pages(cache: dict, src_ids, dst_ids) -> dict:
    """Duplicate pages ``src_ids`` of the paged pool into ``dst_ids``
    (both (n,) ints), in place on the pool's device: the device half of
    copy-on-write.  A sequence about to write into a page it shares with
    the prefix index first copies the page into a private one and
    redirects its block table; whole pages move, so the fork is
    bit-exact with the shared original.  Returns the cache."""
    for sub in cache.values():
        for pool in sub.values():
            src = _page_index(src_ids, 0, pool.device)
            pool[:, _page_index(dst_ids, 0, pool.device)] = pool[:, src]
    return cache


def _lm_logits(params, cfg, x):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, transpose=True)
    return L.unembed(params["lm_head"], x, transpose=False)


def _ffn(p, cfg, x, *, drop_free=True, capacity=None):
    """The block's residual MLP; the tree decides which, as in the
    reference: the MoE MLP (routing ``drop_free`` under ``capacity``,
    see ``moe.moe_fwd``), a biased GELU MLP (it holds ``b_up``) or a
    SwiGLU.  Returns (x, aux): the MoE aux (the overflow count under a
    capacity bound), None for a dense MLP."""
    h = L.norm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = M.moe_fwd(p["moe"], cfg, h, drop_free=drop_free,
                           capacity=capacity)
        return x + y, aux
    mlp = L.gelu_mlp if "b_up" in p["mlp"] else L.swiglu
    return x + mlp(p["mlp"], h), None


def _ln1(p, cfg, x, x_extra):
    """Pre-norm input; zamba2's shared block norms concat(x, x_extra)."""
    if x_extra is not None:
        x = torch.cat([x, x_extra], dim=-1)
    return L.norm(p["ln1"], x, cfg.norm_eps)


def _attn_block_fwd(p, cfg, x, positions, *, window, mode, x_extra=None,
                    moe=None):
    """Pre-norm residual attention + MLP block over a full sequence.
    ``moe``: ``_ffn``'s routing keywords.  Returns (x, aux, kv) with kv
    (k, v), or (ckv, k_rope) for MLA."""
    h = _ln1(p, cfg, x, x_extra)
    if cfg.mla is not None:
        a, kv = A.mla_fwd(p["attn"], cfg, h, positions, mode=mode,
                          return_cache=True)
    else:
        a, kv = A.attention_fwd(p["attn"], cfg, h, positions, window=window,
                                mode=mode, return_kv=True)
    x, aux = _ffn(p, cfg, x + a, **(moe or {}))
    return x, aux, kv


def _attn_block_decode(p, cfg, x, cache: dict, pos, *, window,
                       x_extra=None, block_tables=None):
    """One decode step of the block against its layer's cache (``k``/``v``
    or MLA's ``ckv``/``krope`` views, written in place): contiguous
    rows, or the paged pool read through ``block_tables``.  MoE routing
    is drop-free, as on every serving path."""
    h = _ln1(p, cfg, x, x_extra)
    if cfg.mla is not None:
        fn = A.mla_decode if block_tables is None else A.mla_paged_decode
        args = (cache["ckv"], cache["krope"], pos)
        kw = {}
    else:
        fn = (A.attention_decode if block_tables is None
              else A.paged_attention_decode)
        args = (cache["k"], cache["v"], pos)
        kw = dict(window=window)
    if block_tables is not None:
        args += (block_tables,)
    a, _, _ = fn(p["attn"], cfg, h, *args, **kw)
    return _ffn(p, cfg, x + a)[0]


def _attn_block_prefill_chunk(p, cfg, x, cache: dict, pos_offset: int,
                              n_valid: int, block_tables, *, window,
                              moe_capacity=None):
    """One prompt chunk through the block, its K/V (or latent) written
    straight into the layer's slice of the paged pool.  Returns (x, aux)
    with aux the MoE overflow count under ``moe_capacity`` (None for a
    dense MLP)."""
    h = L.norm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        a, _, _ = A.mla_paged_prefill(p["attn"], cfg, h, cache["ckv"],
                                      cache["krope"], pos_offset, n_valid,
                                      block_tables)
    else:
        a, _, _ = A.paged_prefill_attention(
            p["attn"], cfg, h, cache["k"], cache["v"], pos_offset, n_valid,
            block_tables, window=window)
    return _ffn(p, cfg, x + a, capacity=moe_capacity)


def _layer_cache(stack: dict, *idx) -> dict:
    """The cache leaves of one layer (index ``idx`` of the leading stack
    axes), as views that the block writes in place."""
    return {k: v[idx] for k, v in stack.items()}


def _add_aux(total, aux):
    return total if aux is None else total + aux


# ==========================================================================
# forward (monolithic prefill)
# ==========================================================================

def _attn_forward(params, cfg, x, positions, *, mode, window,
                  return_cache, moe, remat):
    """The attention stacks (dense ``blocks``; moe ``blocks_dense`` then
    ``blocks_moe``) over a full sequence.  Returns (x, summed MoE aux,
    cache).  With ``remat`` under autograd each block's activations are
    recomputed in the backward (``torch.utils.checkpoint``, the twin of
    the reference's ``jax.checkpoint`` around its scan body)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    cache = {} if return_cache else None
    remat = remat and torch.is_grad_enabled()
    for name, n in attn_stacks(cfg):
        kvs = []
        for lp in _unbind_params(params[name], n):
            def block(x, lp=lp):
                return _attn_block_fwd(lp, cfg, x, positions, window=window,
                                       mode=mode, moe=moe)
            x, a, kv = (checkpoint(block, x, use_reentrant=False) if remat
                        else block(x))
            aux = _add_aux(aux, a)
            if return_cache:
                kvs.append(kv)
        if return_cache:
            leaves = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
            cache[name] = {leaf: torch.stack([kv[j] for kv in kvs])
                           for j, leaf in enumerate(leaves)}
    return x, aux, cache


def _block(fn, remat: bool):
    """``fn(x)``, recomputed in the backward under autograd when
    ``remat`` (``torch.utils.checkpoint``, the twin of ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return lambda x: checkpoint(fn, x, use_reentrant=False)
    return fn


def _stack_states(states, shape):
    """Per-block state dicts as leaves with the leading ``shape``."""
    return {k: torch.stack([st[k] for st in states])
            .reshape(*shape, *states[0][k].shape) for k in states[0]}


def _mamba_stack(layers, cfg, x, return_cache, remat):
    """Run the Mamba2 blocks ``layers`` (per-block param dicts) as
    residuals; returns (x, their states in order)."""
    states = []
    for lp in layers:
        if return_cache:
            y, st = SSM.mamba2_fwd(lp, cfg, x, return_state=True)
            states.append(st)
            x = x + y
        else:
            x = _block(lambda x, lp=lp: x + SSM.mamba2_fwd(lp, cfg, x),
                       remat)(x)
    return x, states


def _zamba_forward(params, cfg, x, positions, *, mode, window,
                   return_cache, remat):
    """The twin of the reference's ``_zamba_forward``: ``units`` times
    k_every Mamba2 blocks then the shared attention block on
    concat(x, embedding) through its per-unit adapter, then the tail.
    With ``remat`` under autograd each Mamba2 block and each application
    of the shared block is recomputed in the backward."""
    emb0 = x                                   # original embedding stream
    units, k, tail = _hybrid_layout(cfg)
    mamba_sts, ks, vs = [], [], []
    adapters = torch.unbind(params["shared_adapters"])
    for unit, adapter in zip(_stack_layers(params["mamba_units"], (units, k)),
                             adapters):
        x, sts = _mamba_stack(unit, cfg, x, return_cache, remat)
        y, _, (kk, vv) = _block(
            lambda x: _attn_block_fwd(params["shared_attn"], cfg, x,
                                      positions, window=window, mode=mode,
                                      x_extra=emb0), remat)(x)
        x = x + (y - x) @ adapter
        if return_cache:
            mamba_sts += sts
            ks.append(kk)
            vs.append(vv)
    cache = None
    if return_cache:
        cache = {"mamba_units": _stack_states(mamba_sts, (units, k)),
                 "shared_attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    if tail:
        x, sts = _mamba_stack(_stack_layers(params["mamba_tail"], (tail,)),
                              cfg, x, return_cache, remat)
        if return_cache:
            cache["mamba_tail"] = _stack_states(sts, (tail,))
    return x, cache


def _xlstm_forward(params, cfg, x, *, return_cache, remat):
    """The twin of the reference's ``_xlstm_forward``: ``units`` times
    ``per`` mLSTM blocks then one sLSTM block, each with its own
    residual; with ``remat`` under autograd each block is recomputed in
    the backward."""
    units, per = _xlstm_layout(cfg)
    msts, ssts = [], []
    for mlayers, sp in zip(_stack_layers(params["mlstm_units"], (units, per)),
                           _stack_layers(params["slstm_units"], (units,))):
        for lp in mlayers:
            if return_cache:
                x, st = X.mlstm_block_fwd(lp, cfg, x, return_state=True)
                msts.append(st)
            else:
                x = _block(lambda x, lp=lp: X.mlstm_block_fwd(lp, cfg, x),
                           remat)(x)
        if return_cache:
            x, st = X.slstm_block_fwd(sp, cfg, x, return_state=True)
            ssts.append(st)
        else:
            x = _block(lambda x, sp=sp: X.slstm_block_fwd(sp, cfg, x),
                       remat)(x)
    cache = None
    if return_cache:
        cache = {"mlstm_units": _stack_states(msts, (units, per)),
                 "slstm_units": _stack_states(ssts, (units,))}
    return x, cache


def _forward_hidden(params, cfg, tokens, *, mode, window, return_cache,
                    moe, remat=False):
    """The layer stack over ``tokens`` (B, S): hidden states after the
    last block, the summed MoE aux and the cache its prefill leaves
    (dense and moe: per-layer k/v or MLA latents per stack; hybrid: the
    zamba2 tree; ssm: the xLSTM states)."""
    require_ported(cfg, "forward")
    window = window or cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    zero = torch.zeros((), dtype=F32, device=x.device)
    if cfg.family == "hybrid":
        x, cache = _zamba_forward(params, cfg, x, positions, mode=mode,
                                  window=window, return_cache=return_cache,
                                  remat=remat)
        return x, zero, cache
    if cfg.family == "ssm":
        x, cache = _xlstm_forward(params, cfg, x, return_cache=return_cache,
                                  remat=remat)
        return x, zero, cache
    return _attn_forward(params, cfg, x, positions, mode=mode,
                         window=window, return_cache=return_cache, moe=moe,
                         remat=remat)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", moe_drop_free: bool = False,
            moe_capacity=None, window: int = 0,
            return_cache: bool = False, return_hidden: bool = False,
            remat: bool = True):
    """Returns (logits (B, S, V) fp32, aux [, cache][, hidden]).
    ``batch["tokens"]``: (B, S) int32.  With ``return_cache`` the cache
    has ``init_cache``'s tree with batch B and sequence S, ready for
    ``graft_slot_cache``.  Attention runs the flash kernel
    (``mode="flash"``) once per layer (hybrid: once per unit; MLA at q/k
    head dim 192 and v head dim 128 at deepseek's widths), and every
    Mamba2 block the SSD scan kernel once; the xLSTM blocks run no
    kernel.

    aux: 0 for dense and hybrid; for moe the summed load-balance loss,
    or, with ``moe_drop_free`` and ``moe_capacity``, the summed count of
    routings that overflowed the capacity bound (0 means token-exact
    with the unbounded drop-free path; the engines double and retry
    otherwise).  ``moe_drop_free`` is required on serving forwards, as
    in the reference (its default False is the training behaviour).

    hidden (``return_hidden``): the last block's output before the final
    norm (B, S, d), which ``mtp_logits`` reads.  ``remat``: recompute
    each block in the backward; it changes nothing without autograd.
    The forward records a graph when grad is enabled and a param
    requires grad: serving callers run it under ``torch.no_grad()``."""
    moe = dict(drop_free=moe_drop_free, capacity=moe_capacity)
    x, aux, cache = _forward_hidden(params, cfg, batch["tokens"], mode=mode,
                                    window=window, return_cache=return_cache,
                                    moe=moe, remat=remat)
    hidden = x
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, cfg, x)
    out = (logits, aux)
    if return_cache:
        out += (cache,)
    if return_hidden:
        out += (hidden,)
    return out


def mtp_logits(params: dict, cfg: ModelConfig, hidden, tokens, *,
               mode: str = "flash") -> torch.Tensor:
    """MTP head: h'_t = proj([norm(h_t); norm(emb(tok_{t+1}))]) for t in
    [0, S-2), one extra block, the shared unembedding -> predicts
    tok_{t+2}.  Returns logits (B, S-2, V) fp32."""
    p = params["mtp"]
    B, S = tokens.shape
    h = L.rmsnorm(p["norm_h"], hidden[:, :S - 2], cfg.norm_eps)
    e = L.rmsnorm(p["norm_e"], L.embed(params["embed"], tokens[:, 1:S - 1]),
                  cfg.norm_eps)
    x = torch.cat([h, e], dim=-1) @ p["proj"]
    positions = torch.arange(S - 2, device=x.device)[None].expand(B, S - 2)
    x, _, _ = _attn_block_fwd(p["block"], cfg, x, positions, window=0,
                              mode=mode)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, x)


def _token_nll(logits, targets):
    """-log_softmax(logits)[target], in fp32, by a gather (the
    reference's ``take_along_axis``)."""
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", remat: bool = True):
    """Next-token cross-entropy (over ``batch["loss_mask"][:, 1:]`` when
    given) + the summed MoE load-balance aux + the MTP loss when the
    config carries an MTP head (deepseek-v3).  Returns (total, metrics)
    with metrics {"loss", "aux_loss", "mtp_loss", "perplexity"}, 0-d
    tensors."""
    tokens = batch["tokens"]
    mtp_loss = torch.zeros((), dtype=F32, device=tokens.device)
    if cfg.use_mtp:
        logits, aux, hidden = forward(params, cfg, batch, mode=mode,
                                      return_hidden=True, remat=remat)
        ml = mtp_logits(params, cfg, hidden, tokens, mode=mode)
        mtp_loss = cfg.mtp_weight * _token_nll(ml, tokens[:, 2:]).mean()
    else:
        logits, aux = forward(params, cfg, batch, mode=mode, remat=remat)
    nll = _token_nll(logits[:, :-1], tokens[:, 1:])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(F32)
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        loss = nll.mean()
    total = loss + aux + mtp_loss
    return total, {"loss": loss, "aux_loss": aux, "mtp_loss": mtp_loss,
                   "perplexity": torch.exp(torch.clamp_max(loss, 20.0))}


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", moe_capacity=None,
            return_aux: bool = False):
    """Run the full prompt (MoE routing drop-free, under ``moe_capacity``
    if given), returning (last-position logits (B, 1, V), cache), or
    (logits, aux, cache) with ``return_aux`` (aux: the overflow count
    under ``moe_capacity``, see ``forward``).  Only the last position is
    unembedded: the JAX function computes every position's logits and
    slices the last."""
    moe = dict(drop_free=True, capacity=moe_capacity)
    x, aux, cache = _forward_hidden(params, cfg, batch["tokens"], mode=mode,
                                    window=0, return_cache=True, moe=moe)
    x = L.norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = _lm_logits(params, cfg, x)
    if return_aux:
        return logits, aux, cache
    return logits, cache


# ==========================================================================
# decode step (contiguous cache or paged pool)
# ==========================================================================

def _step_in_place(fn, lp, cfg, x, cache: dict, idx):
    """One recurrent block's decode step ``fn(lp, cfg, x, entry)`` on the
    cache entry at ``idx`` of the stacked state leaves, written back in
    place; returns the block's output."""
    entry = {k: v[idx] for k, v in cache.items()}
    y, new = fn(lp, cfg, x, entry)
    for k, v in new.items():
        entry[k].copy_(v)
    return y


def _zamba_decode(params, cfg, x, cache, pos, window):
    emb0 = x
    units, k, tail = _hybrid_layout(cfg)
    mp, mc, ac = params["mamba_units"], cache["mamba_units"], \
        cache["shared_attn"]
    for u in range(units):
        for j in range(k):
            x = x + _step_in_place(SSM.mamba2_decode, layer_params(mp, u, j),
                                   cfg, x, mc, (u, j))
        y = _attn_block_decode(params["shared_attn"], cfg, x,
                               _layer_cache(ac, u), pos, window=window,
                               x_extra=emb0)
        x = x + (y - x) @ params["shared_adapters"][u]
    for i in range(tail):
        x = x + _step_in_place(SSM.mamba2_decode,
                               layer_params(params["mamba_tail"], i), cfg, x,
                               cache["mamba_tail"], (i,))
    return x


def _xlstm_decode(params, cfg, x, cache):
    units, per = _xlstm_layout(cfg)
    for u in range(units):
        for j in range(per):
            x = _step_in_place(X.mlstm_block_decode,
                               layer_params(params["mlstm_units"], u, j), cfg,
                               x, cache["mlstm_units"], (u, j))
        x = _step_in_place(X.slstm_block_decode,
                           layer_params(params["slstm_units"], u), cfg, x,
                           cache["slstm_units"], (u,))
    return x


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos,
                block_tables=None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) int32.  pos: an int or 0-d
    tensor (every sequence at the same position: the fixed-slot engine)
    or a (B,) int32 tensor of per-sequence write positions (continuous
    batching); the ssm family's recurrent state has no positions and
    ignores it.  block_tables: None for a contiguous ``init_cache``
    cache, else (B, max_pages) int32 page ids into an
    ``init_paged_cache`` pool (dense and moe; scratch page 0 for idle
    slots and unused entries; pos must then be (B,)).  MoE routing is
    drop-free.  Returns (logits (B, 1, V) fp32, cache) with the cache
    written in place."""
    require_ported(cfg, "decode_step")
    if block_tables is not None:
        require_paged(cfg, "decode_step")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.family == "hybrid":
        x = _zamba_decode(params, cfg, x, cache, pos, window)
    elif cfg.family == "ssm":
        x = _xlstm_decode(params, cfg, x, cache)
    else:
        for name, n in attn_stacks(cfg):
            for i in range(n):
                x = _attn_block_decode(
                    layer_params(params[name], i), cfg, x,
                    _layer_cache(cache[name], i), pos, window=window,
                    block_tables=block_tables)
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache


# ==========================================================================
# chunked prefill into the paged cache (unified token-budget step)
# ==========================================================================

@torch.no_grad()
def prefill_chunk(params: dict, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, n_valid: int, pos_offset: int,
                  block_tables: torch.Tensor, *, moe_capacity=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One prompt chunk of a single sequence, written straight into the
    paged pool (dense and moe; MLA writes its latents).  tokens: (1, C)
    int32, chunk positions ``[pos_offset, pos_offset + C)`` of which the
    first ``n_valid`` are real (pads write to the scratch page).
    block_tables: (1, max_pages) int32 covering positions
    [0, pos_offset + n_valid).

    Returns (logits (1, C, V) fp32, moe_overflow, cache).
    ``logits[0, i]`` is the next-token distribution after position
    ``pos_offset + i``; admission reads ``logits[0, n_valid - 1]`` and
    speculative verify reads every position.  MoE routing is drop-free;
    ``moe_overflow`` counts the routings that overflowed
    ``moe_capacity`` (0 without one, and for dense): the engine doubles
    the bound and re-runs the chunk, which rewrites the same pool
    positions."""
    require_ported(cfg, "prefill_chunk")
    require_paged(cfg, "prefill_chunk")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for name, n in attn_stacks(cfg):
        for i in range(n):
            x, a = _attn_block_prefill_chunk(
                layer_params(params[name], i), cfg, x,
                _layer_cache(cache[name], i), pos_offset, n_valid,
                block_tables, window=window, moe_capacity=moe_capacity)
            aux = _add_aux(aux, a)
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, x), aux, cache
