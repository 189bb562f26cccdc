"""Model assembly for the dense and hybrid (zamba2) families: the twin of
the JAX package's ``models/transformer.py`` on the serving paths.

    params          = init_params(cfg, seed=0, device="cuda")
    # contiguous cache (fixed-slot engine, contiguous SlotManager)
    cache           = init_cache(cfg, B, max_seq, device)
    logits, _, pcache = forward(params, cfg, {"tokens": t},
                                return_cache=True)
    cache           = graft_slot_cache(cache, pcache, slot)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos)
    # paged pool (continuous engine, dense only)
    cache           = init_paged_cache(cfg, n_pages, page_size, device)
    logits, _, cache = prefill_chunk(params, cfg, cache, tokens, n_valid,
                                     pos_offset, block_tables)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos,
                                  block_tables=block_tables)
    snap            = extract_paged_cache(cache, page_ids, since)  # spill
    cache           = graft_paged_cache(cache, snap, new_ids)      # resume

Params keep the JAX tree paths (dense: ``embed``, ``final_norm/scale``,
``blocks/{ln1,attn,ln2,mlp}/...`` with a leading layer axis; hybrid:
``mamba_units/...`` with leading (units, k_every) axes, ``mamba_tail``,
``shared_attn`` and ``shared_adapters``), so ``repro_torch.bridge`` maps
a JAX params tree leaf for leaf.  The ``jax.lax.scan`` over layers is a
Python loop over views of the stacked tensors.  Caches and pools are
updated in place (see ``models.attention``).  Everything here is
inference: it runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

F32 = torch.float32
PORTED_FAMILIES = ("dense", "hybrid")
# the paged KV pool (and the chunked prefill and decode that read it) is
# dense-only: recurrent state is fixed-size per slot and stays contiguous,
# as in the reference
PAGED_FAMILIES = ("dense",)


def require_ported(cfg: ModelConfig, what: str) -> None:
    """Raise for a family the port does not serve yet (moe, ssm, audio,
    vlm; MLA and MoE sub-configs)."""
    if cfg.family not in PORTED_FAMILIES or cfg.mla is not None \
            or cfg.moe is not None:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet "
            f"({' and '.join(PORTED_FAMILIES)} only)")


def require_paged(cfg: ModelConfig, what: str) -> None:
    """Raise for a family with no paged KV cache (hybrid and every other
    recurrent family)."""
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


# ==========================================================================
# init
# ==========================================================================

def _init_attn_block(cfg: ModelConfig, gen, dev, lead=(), d_in=None) -> dict:
    """Pre-norm attention + MLP block params (SwiGLU, or the biased GELU
    MLP for ``mlp_type="gelu"``) with leading stack axes ``lead``;
    ``d_in`` widens ln1 and the q/k/v projections (zamba2's shared block
    reads concat(hidden, embedding), 2 * d_model)."""
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p = {"ln1": L.init_rmsnorm(d_in or d, dt, dev, lead),
         "attn": A.init_attention(cfg, gen, dev, lead, d_in=d_in),
         "ln2": L.init_rmsnorm(d, dt, dev, lead)}
    init_mlp = L.init_gelu_mlp if cfg.mlp_type == "gelu" else L.init_swiglu
    p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt, dev, lead)
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
    return p


def layer_params(stacked: dict, *idx) -> dict:
    """The params at index ``idx`` of the leading stack axes, as views
    into the stacked tensors."""
    return {k: layer_params(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in stacked.items()}


def _attn_cache(cfg: ModelConfig, n: int, B: int, max_seq: int, dt, dev):
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


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cuda") -> dict:
    """Zero contiguous cache.  Dense: ``{"blocks": {"k", "v"}}`` with
    leaves (L, B, S_cache, Hkv, D) in the activation dtype (S_cache is
    max_seq, or the ring length ``min(max_seq, sliding_window)``).
    Hybrid: ``mamba_units`` {"ssm" (units, k, B, H, P, N) fp32, "conv"
    (units, k, B, d_conv-1, conv_ch)}, ``shared_attn`` {"k", "v"} with
    ONE K/V stack per unit (units, B, S_cache, Hkv, D), and
    ``mamba_tail`` {"ssm", "conv"} with a leading (tail,) axis."""
    require_ported(cfg, "init_cache")
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.activation_dtype)
    if cfg.family == "dense":
        return {"blocks": _attn_cache(cfg, cfg.n_layers, B, max_seq, dt, dev)}
    units, k, tail = _hybrid_layout(cfg)
    c = {"mamba_units": _mamba_cache(cfg, (units, k), B, dt, dev),
         "shared_attn": _attn_cache(cfg, units, B, max_seq, dt, dev)}
    if tail:
        c["mamba_tail"] = _mamba_cache(cfg, (tail,), B, dt, dev)
    return c


def _batch_axis_slices(big: torch.Tensor, small_shape, slot: int):
    """Index of the region ``small_shape`` covers in ``big`` at ``slot``:
    the batch axis is the first axis where the shapes differ (axis 1 of a
    dense or shared-attention or tail leaf, axis 2 of a ``mamba_units``
    leaf), and any later mismatch (the shorter sequence axis) starts at
    0."""
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
    """Zero paged KV pool ``{"blocks": {"k", "v"}}`` with leaves
    (L, n_pages, page_size, Hkv, D) in the activation dtype; page 0 is
    the scratch page.  Which sequence owns which page lives in the
    engine's block tables.  Dense only: recurrent state (hybrid) is
    fixed-size per slot and keeps the contiguous layout, as in the
    reference."""
    require_ported(cfg, "init_paged_cache")
    require_paged(cfg, "init_paged_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dt = L.dtype_of(cfg.activation_dtype)
    return {"blocks": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


def _page_index(page_ids, since: int, device) -> torch.Tensor:
    ids = torch.as_tensor(page_ids, dtype=torch.long)
    return ids[since:].to(device)


def graft_paged_cache(cache: dict, prefix_cache: dict, page_ids,
                      since: int = 0) -> dict:
    """Scatter a single-sequence prefix cache (leaves (L, 1, S_b, Hkv, D),
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
    single-sequence prefix cache (leaves (L, 1, n * page_size, Hkv, D) on
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


def _lm_logits(params, cfg, x):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, transpose=True)
    return L.unembed(params["lm_head"], x, transpose=False)


def _mlp(p, cfg, x):
    """The block's residual MLP; the tree decides which, as in the
    reference (a biased GELU MLP holds ``b_up``)."""
    h = L.norm(p["ln2"], x, cfg.norm_eps)
    mlp = L.gelu_mlp if "b_up" in p["mlp"] else L.swiglu
    return x + mlp(p["mlp"], h)


def _ln1(p, cfg, x, x_extra):
    """Pre-norm input; zamba2's shared block norms concat(x, x_extra)."""
    if x_extra is not None:
        x = torch.cat([x, x_extra], dim=-1)
    return L.norm(p["ln1"], x, cfg.norm_eps)


def _attn_block_fwd(p, cfg, x, positions, *, window, mode, x_extra=None):
    """Pre-norm residual attention + MLP block over a full sequence.
    Returns (x, (k, v))."""
    a, kv = A.attention_fwd(p["attn"], cfg, _ln1(p, cfg, x, x_extra),
                            positions, window=window, mode=mode,
                            return_kv=True)
    return _mlp(p, cfg, x + a), kv


def _attn_block_decode(p, cfg, x, cache_k, cache_v, pos, *, window,
                       x_extra=None):
    """One decode step of the block against a contiguous cache (written
    in place)."""
    a, _, _ = A.attention_decode(p["attn"], cfg, _ln1(p, cfg, x, x_extra),
                                 cache_k, cache_v, pos, window=window)
    return _mlp(p, cfg, x + a)


# ==========================================================================
# forward (monolithic prefill)
# ==========================================================================

def _dense_forward(params, cfg, x, positions, *, mode, window,
                   return_cache):
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_block_fwd(layer_params(params["blocks"], i), cfg,
                                    x, positions, window=window, mode=mode)
        if return_cache:
            ks.append(k)
            vs.append(v)
    cache = ({"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if return_cache else None)
    return x, cache


def _mamba_stack(stack, idx_list, cfg, x, return_cache):
    """Run the Mamba2 blocks at ``idx_list`` of ``stack`` as residuals;
    returns (x, their states in order)."""
    states = []
    for idx in idx_list:
        lp = layer_params(stack, *idx)
        if return_cache:
            y, st = SSM.mamba2_fwd(lp, cfg, x, return_state=True)
            states.append(st)
        else:
            y = SSM.mamba2_fwd(lp, cfg, x)
        x = x + y
    return x, states


def _stack_states(states, shape):
    """Per-block state dicts as leaves with the leading ``shape``."""
    return {k: torch.stack([st[k] for st in states])
            .reshape(*shape, *states[0][k].shape) for k in ("ssm", "conv")}


def _zamba_forward(params, cfg, x, positions, *, mode, window,
                   return_cache):
    """The twin of the reference's ``_zamba_forward``: ``units`` times
    k_every Mamba2 blocks then the shared attention block on
    concat(x, embedding) through its per-unit adapter, then the tail."""
    emb0 = x                                   # original embedding stream
    units, k, tail = _hybrid_layout(cfg)
    mamba_sts, ks, vs = [], [], []
    for u in range(units):
        x, sts = _mamba_stack(params["mamba_units"],
                              [(u, j) for j in range(k)], cfg, x,
                              return_cache)
        y, (kk, vv) = _attn_block_fwd(params["shared_attn"], cfg, x,
                                      positions, window=window, mode=mode,
                                      x_extra=emb0)
        x = x + (y - x) @ params["shared_adapters"][u]
        if return_cache:
            mamba_sts += sts
            ks.append(kk)
            vs.append(vv)
    cache = None
    if return_cache:
        cache = {"mamba_units": _stack_states(mamba_sts, (units, k)),
                 "shared_attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    if tail:
        x, sts = _mamba_stack(params["mamba_tail"],
                              [(i,) for i in range(tail)], cfg, x,
                              return_cache)
        if return_cache:
            cache["mamba_tail"] = _stack_states(sts, (tail,))
    return x, cache


def _forward_hidden(params, cfg, tokens, *, mode, window, return_cache):
    """The layer stack over ``tokens`` (B, S): hidden states after the
    last block, and the cache its prefill leaves (dense: per-layer k/v;
    hybrid: the zamba2 tree)."""
    require_ported(cfg, "forward")
    window = window or cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    body = _dense_forward if cfg.family == "dense" else _zamba_forward
    return body(params, cfg, x, positions, mode=mode, window=window,
                return_cache=return_cache)


@torch.no_grad()
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", window: int = 0,
            return_cache: bool = False):
    """Returns (logits (B, S, V) fp32, aux_loss (0: dense and hybrid)
    [, cache]).  ``batch["tokens"]``: (B, S) int32.  With
    ``return_cache`` the cache has ``init_cache``'s tree with batch B and
    sequence S, ready for ``graft_slot_cache``.  Attention runs the flash
    kernel (``mode="flash"``) once per layer (hybrid: once per unit), and
    every Mamba2 block the SSD scan kernel once."""
    x, cache = _forward_hidden(params, cfg, batch["tokens"], mode=mode,
                               window=window, return_cache=return_cache)
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, cfg, x)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if return_cache:
        return logits, aux, cache
    return logits, aux


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash") -> Tuple[torch.Tensor, dict]:
    """Run the full prompt, returning (last-position logits (B, 1, V),
    cache).  Only the last position is unembedded: the JAX function
    computes every position's logits and slices the last."""
    x, cache = _forward_hidden(params, cfg, batch["tokens"], mode=mode,
                               window=0, return_cache=True)
    x = L.norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache


# ==========================================================================
# decode step (contiguous cache or paged pool)
# ==========================================================================

def _mamba_step(lp, cfg, x, cache: dict, idx):
    """One Mamba2 decode step on the cache entry at ``idx`` of the
    stacked state leaves, written back in place."""
    entry = {k: v[idx] for k, v in cache.items()}
    y, new = SSM.mamba2_decode(lp, cfg, x, entry)
    for k, v in new.items():
        entry[k].copy_(v)
    return x + y


def _zamba_decode(params, cfg, x, cache, pos, window):
    emb0 = x
    units, k, tail = _hybrid_layout(cfg)
    mp, mc, ac = params["mamba_units"], cache["mamba_units"], \
        cache["shared_attn"]
    for u in range(units):
        for j in range(k):
            x = _mamba_step(layer_params(mp, u, j), cfg, x, mc, (u, j))
        y = _attn_block_decode(params["shared_attn"], cfg, x, ac["k"][u],
                               ac["v"][u], pos, window=window, x_extra=emb0)
        x = x + (y - x) @ params["shared_adapters"][u]
    for i in range(tail):
        x = _mamba_step(layer_params(params["mamba_tail"], i), cfg, x,
                        cache["mamba_tail"], (i,))
    return x


@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos,
                block_tables=None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) int32.  pos: an int or 0-d
    tensor (every sequence at the same position: the fixed-slot engine)
    or a (B,) int32 tensor of per-sequence write positions (continuous
    batching).  block_tables: None for a contiguous ``init_cache``
    cache, else (B, max_pages) int32 page ids into an
    ``init_paged_cache`` pool (dense only; scratch page 0 for idle slots
    and unused entries; pos must then be (B,)).  Returns (logits
    (B, 1, V) fp32, cache) with the cache written in place."""
    require_ported(cfg, "decode_step")
    if block_tables is not None:
        require_paged(cfg, "decode_step")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.family == "hybrid":
        x = _zamba_decode(params, cfg, x, cache, pos, window)
    else:
        blocks, kv = params["blocks"], cache["blocks"]
        for i in range(cfg.n_layers):
            lp = layer_params(blocks, i)
            if block_tables is None:
                x = _attn_block_decode(lp, cfg, x, kv["k"][i], kv["v"][i],
                                       pos, window=window)
                continue
            h = L.norm(lp["ln1"], x, cfg.norm_eps)
            a, _, _ = A.paged_attention_decode(
                lp["attn"], cfg, h, kv["k"][i], kv["v"][i], pos,
                block_tables, window=window)
            x = _mlp(lp, cfg, x + a)
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache


# ==========================================================================
# chunked prefill into the paged cache (unified token-budget step)
# ==========================================================================

@torch.no_grad()
def prefill_chunk(params: dict, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, n_valid: int, pos_offset: int,
                  block_tables: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One prompt chunk of a single sequence, written straight into the
    paged pool (dense only).  tokens: (1, C) int32, chunk positions
    ``[pos_offset, pos_offset + C)`` of which the first ``n_valid`` are
    real (pads write to the scratch page).  block_tables: (1, max_pages)
    int32 covering positions [0, pos_offset + n_valid).

    Returns (logits (1, C, V) fp32, moe_overflow (0: dense), cache).
    ``logits[0, i]`` is the next-token distribution after position
    ``pos_offset + i``; admission reads ``logits[0, n_valid - 1]`` and
    speculative verify reads every position."""
    require_ported(cfg, "prefill_chunk")
    require_paged(cfg, "prefill_chunk")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    blocks, pool = params["blocks"], cache["blocks"]
    for i in range(cfg.n_layers):
        lp = layer_params(blocks, i)
        h = L.norm(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = A.paged_prefill_attention(
            lp["attn"], cfg, h, pool["k"][i], pool["v"][i], pos_offset,
            n_valid, block_tables, window=window)
        x = _mlp(lp, cfg, x + a)
    x = L.norm(params["final_norm"], x, cfg.norm_eps)
    return (_lm_logits(params, cfg, x),
            torch.zeros((), dtype=F32, device=x.device), cache)
