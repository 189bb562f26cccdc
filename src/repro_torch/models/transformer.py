"""Model assembly for the dense, moe (qwen3-moe; deepseek-v3 with MLA),
hybrid (zamba2), ssm (xLSTM), audio (whisper) and vlm (qwen2-vl)
families: the twin of the JAX package's ``models/transformer.py`` on
the serving and training paths.

    params          = init_params(cfg, seed=0, device="cuda", max_seq=4096)
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
    # training (every family)
    loss, metrics   = loss_fn(params, cfg, {"tokens": t})
    # side inputs: batch["audio_frames"] (B, F, d) for audio, and
    # batch["patch_embeds"] (B, P, d) for vlm, ahead of the text

Params keep the JAX tree paths (dense: ``embed``, ``final_norm/scale``,
``blocks/{ln1,attn,ln2,mlp}/...`` with a leading layer axis; moe:
``blocks_dense`` (the leading dense-MLP layers, if any) and
``blocks_moe/{...,moe}/...``, MLA leaves under ``attn`` for deepseek,
and ``mtp``; hybrid: ``mamba_units/...`` with leading (units, k_every)
axes, ``mamba_tail``, ``shared_attn`` and ``shared_adapters``; ssm:
``mlstm_units/...`` with leading (units, slstm_every - 1) axes and
``slstm_units/...`` with a leading (units,) axis; audio: ``enc_blocks``
and ``dec_blocks`` (with ``ln_x`` and ``xattn``, the cross-attention),
LayerNorm leaves ``scale``/``bias``, ``enc_ln``, ``dec_pos`` (max_seq,
d) and ``lm_head``; vlm: dense's ``blocks``), so
``repro_torch.bridge`` maps a JAX params tree leaf for leaf.  The KV
trees follow the same stacks; MLA caches hold the latent ``ckv`` and
the rotary key ``krope`` instead of ``k`` and ``v``, and whisper's
``dec`` stack also the cross-attention's static ``xk``/``xv``.  The
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

Under a serving mesh (``models.pspec.mesh_rules`` installed; params cut
by ``launch.sharding.shard_params``) ``prefill_chunk`` and the paged
``decode_step`` run tensor- and expert-parallel on the rank's slices
(``models.layers``, ``models.attention``, ``models.moe``), and the paged
pool is the rank's: ``init_paged_cache`` allocates its local leaves,
``copy_paged_pages`` copies local pages, ``extract_paged_cache``
returns WHOLE pages (an exact gather over the ranks) and
``graft_paged_cache`` takes the rank's slice of whole pages, so spills,
checkpoints and handovers do not depend on the rank count.  Under a
prefill or decode step's mesh (``launch.steps``) ``prefill`` returns,
and the contiguous ``decode_step`` takes, the rank's slice of the
cache by the reference's rule (``launch.sharding.rank_cache``): its
positions cut over "seq" where the KV heads do not divide 16.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import pspec as PS
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as X

F32 = torch.float32
# the paged KV pool (and the chunked prefill and decode that read it) is
# for the attention families: recurrent state is fixed-size per slot and
# stays contiguous, and whisper and qwen2-vl need per-request side inputs
# (and learned or M-RoPE positions), as in the reference
PAGED_FAMILIES = ("dense", "moe")


def require_paged(cfg: ModelConfig, what: str) -> None:
    """Raise for a family with no paged KV cache (hybrid, ssm, audio,
    vlm)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"{what}: no paged KV cache for family {cfg.family!r} "
            "(recurrent families keep their fixed-size state path; audio "
            "and vlm are served by the fixed-slot engine)")


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
    """(name, layers) of the attention stacks of a dense, vlm or moe
    config, in order: dense and vlm ``blocks``; moe ``blocks_dense`` (its
    leading dense-MLP layers, when it has any) then ``blocks_moe``."""
    if cfg.family in ("dense", "vlm"):
        return (("blocks", cfg.n_layers),)
    nd = cfg.moe.n_dense_layers
    return ((("blocks_dense", nd),) if nd else ()) + (
        ("blocks_moe", cfg.n_layers - nd),)


# ==========================================================================
# init
# ==========================================================================

def _init_attn_block(cfg: ModelConfig, gen, dev, lead=(), d_in=None,
                     use_moe: bool = False, dense_ff=None, gelu: bool = False,
                     cross: bool = False) -> dict:
    """Pre-norm attention + MLP block params with leading stack axes
    ``lead``: GQA attention, or MLA when the config has it; with
    ``cross`` (whisper's decoder) the cross-attention's ``ln_x`` and
    ``xattn``; then the MoE MLP (``use_moe``), or a SwiGLU (the biased
    GELU MLP for ``gelu`` or ``mlp_type="gelu"``) of width ``dense_ff
    or d_ff``.  The norms are LayerNorms for an encoder-decoder config,
    else RMSNorms.  ``d_in`` widens ln1 and the q/k/v projections
    (zamba2's shared block reads concat(hidden, embedding), 2 *
    d_model)."""
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    ln = cfg.is_encoder_decoder                # whisper: LayerNorm w/ bias
    p = {"ln1": L.init_norm(d_in or d, dt, dev, ln, lead)}
    p["attn"] = (A.init_mla(cfg, gen, dev, lead) if cfg.mla is not None
                 else A.init_attention(cfg, gen, dev, lead, d_in=d_in))
    if cross:
        p["ln_x"] = L.init_norm(d, dt, dev, ln, lead)
        p["xattn"] = A.init_attention(cfg, gen, dev, lead)
    p["ln2"] = L.init_norm(d, dt, dev, ln, lead)
    if use_moe:
        p["moe"] = M.init_moe(cfg, gen, dev, lead)
        return p
    init_mlp = (L.init_gelu_mlp if gelu or cfg.mlp_type == "gelu"
                else L.init_swiglu)
    p["mlp"] = init_mlp(gen, d, dense_ff or cfg.d_ff, dt, dev, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                max_seq: int = 4096) -> dict:
    """Random params in the JAX package's layout, drawn from a seeded
    ``torch.Generator`` on ``device`` (they are NOT the JAX package's
    numbers: parity tests load those through ``bridge``).  ``max_seq``
    sizes whisper's learned decoder positions ``dec_pos`` (the decoder
    runs at most that many positions); no other family reads it.  On
    the ``meta`` device the tree holds shapes and dtypes only
    (``param_shapes``)."""
    meta = torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = torch.Generator(device="cpu" if meta else dev)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    p = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
                  * 0.02).to(dt),
        "final_norm": L.init_norm(d, dt, dev, cfg.is_encoder_decoder),
    }
    if cfg.family in ("dense", "vlm"):
        p["blocks"] = _init_attn_block(cfg, gen, dev, lead=(cfg.n_layers,))
    elif cfg.family == "audio":
        p["enc_blocks"] = _init_attn_block(
            cfg, gen, dev, lead=(cfg.n_encoder_layers,), gelu=True)
        p["dec_blocks"] = _init_attn_block(
            cfg, gen, dev, lead=(cfg.n_layers,), gelu=True, cross=True)
        p["enc_ln"] = L.init_layernorm(d, dt, dev)
        p["dec_pos"] = L.embed_init((max_seq, d), dt, gen, dev)
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


def param_shapes(cfg: ModelConfig, max_seq: int = 4096) -> dict:
    """The params tree of ``cfg`` as meta tensors (shapes and dtypes),
    from ``init_params`` on the meta device: nothing is allocated or
    drawn."""
    return init_params(cfg, device="meta", max_seq=max_seq)


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
    axis, so ``max_seq`` is unused.  Audio: ``{"dec": {"k", "v", "xk",
    "xv"}}``, the decoder's self-attention K/V (L, B, max_seq, Hkv, D)
    and the cross-attention's static K/V over the encoder's frames (L,
    B, n_audio_frames, Hkv, D).  Vlm: dense's, its positions counting
    the patches ahead of the text."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.activation_dtype)
    if cfg.family == "ssm":
        return _xlstm_cache(cfg, B, dt, dev)
    if cfg.family == "audio":
        c = _attn_cache(cfg, cfg.n_layers, B, max_seq, dt, dev)
        shape = (cfg.n_layers, B, cfg.n_audio_frames, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        c["xk"] = torch.zeros(shape, dtype=dt, device=dev)
        c["xv"] = torch.zeros(shape, dtype=dt, device=dev)
        return {"dec": c}
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


def paged_cache_shapes(cfg: ModelConfig, n_pages: int,
                       page_size: int) -> dict:
    """The whole shape of every leaf of an ``init_paged_cache`` pool."""
    require_paged(cfg, "paged_cache_shapes")
    if cfg.mla is not None:
        m = cfg.mla
        widths = {"ckv": (m.kv_lora_rank,), "krope": (m.qk_rope_head_dim,)}
    else:
        hd = (cfg.n_kv_heads, cfg.resolved_head_dim)
        widths = {"k": hd, "v": hd}
    return {name: {leaf: (n, n_pages, page_size, *w)
                   for leaf, w in widths.items()}
            for name, n in attn_stacks(cfg)}


def _pool_cuts(cfg: ModelConfig, shapes: dict) -> dict:
    """The cut of every pool leaf under the installed rules (None
    without a mesh or where the width replicates)."""
    return {name: {leaf: SH.pool_cut(cfg, (name, leaf), shape)
                   for leaf, shape in sub.items()}
            for name, sub in shapes.items()}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device="cuda") -> dict:
    """Zero paged KV pool in the activation dtype, one entry per
    attention stack (``attn_stacks``): ``{"k", "v"}`` with leaves
    (L, n_pages, page_size, Hkv, D), or for MLA ``{"ckv", "krope"}``
    with leaves (L, n_pages, page_size, kv_lora_rank / qk_rope_head_dim).
    Page 0 is the scratch page.  Which sequence owns which page lives in
    the engine's block tables.  Dense and moe only: recurrent state
    (hybrid) is fixed-size per slot and keeps the contiguous layout, as
    in the reference.  Under a mesh, the rank's slice of each leaf
    (``launch.sharding.pool_cut``)."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg.activation_dtype)
    shapes = paged_cache_shapes(cfg, n_pages, page_size)
    cuts = _pool_cuts(cfg, shapes)
    return {name: {leaf: torch.zeros(SH.local_shape(shape, cuts[name][leaf]),
                                     dtype=dt, device=dev)
                   for leaf, shape in sub.items()}
            for name, sub in shapes.items()}


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
    ``page_ids`` (the delta half of a KV-delta spill).  Under a mesh the
    prefix holds whole pages and each rank grafts its slice of them.
    Returns the cache."""
    for name, sub in cache.items():
        for leaf, pool in sub.items():
            ids = _page_index(page_ids, since, pool.device)
            ps, n0 = pool.shape[2], ids.shape[0]
            sm = prefix_cache[name][leaf][:, 0]           # (L, S_b, ...)
            for d in range(2, sm.dim()):      # the rank's heads / widths
                whole, k = sm.shape[d], pool.shape[d + 1]
                if whole != k:
                    mesh, axis = L.tp_axis(k, whole)
                    sm = sm.narrow(d, mesh.index(axis) * k, k)
            sm = sm.to(device=pool.device, dtype=pool.dtype)
            if sm.shape[1] < n0 * ps:
                pad = torch.zeros((sm.shape[0], n0 * ps - sm.shape[1],
                                   *sm.shape[2:]), dtype=sm.dtype,
                                  device=sm.device)
                sm = torch.cat([sm, pad], dim=1)
            sm = sm[:, :n0 * ps].reshape(sm.shape[0], n0, ps, *sm.shape[2:])
            pool[:, ids] = sm
    return cache


def extract_paged_cache(cache: dict, page_ids, since: int = 0,
                        cfg: ModelConfig = None) -> dict:
    """Gather pages ``page_ids[since:]`` of the paged pool into a new
    single-sequence prefix cache (leaves (L, 1, n * page_size, ...) on
    the pool's device): the exact inverse of ``graft_paged_cache``.  The
    snapshot is a whole number of pages, so a graft pads nothing and the
    round trip is bit-exact.  Under a mesh (``cfg`` then says which
    leaves the ranks cut) every rank gets the WHOLE pages: the ranks'
    slices gathered exactly (``ServingMesh.gather``), a collective every
    rank makes."""
    mesh = PS.current_mesh()
    cuts = None
    if mesh is not None and mesh.size > 1:
        if cfg is None:
            raise ValueError("extract_paged_cache under a mesh needs cfg")
        cuts = _pool_cuts(cfg, paged_cache_shapes(cfg, 1, 1))
    out = {}
    for name, sub in cache.items():
        out[name] = {}
        for leaf, pool in sub.items():
            sm = pool[:, _page_index(page_ids, since, pool.device)]
            L_, n, ps = sm.shape[:3]
            sm = sm.reshape(L_, 1, n * ps, *sm.shape[3:])
            cut = cuts and cuts[name][leaf]
            out[name][leaf] = (sm if not cut else mesh.gather(
                sm, cut[0], PS.entry_of("model", cut[1])))
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
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return L.unembed(params[name], x, transpose=cfg.tie_embeddings,
                     vocab_size=cfg.vocab_size, path=(name,))


def _ffn(p, cfg, x, *, drop_free=True, capacity=None, dispatch="einsum"):
    """The block's residual MLP; the tree decides which, as in the
    reference: the MoE MLP (routing ``drop_free`` under ``capacity``
    through ``dispatch``, see ``moe.moe_fwd``), a biased GELU MLP (it
    holds ``b_up``) or a SwiGLU.  Returns (x, aux): the MoE aux (the
    overflow count under a capacity bound), None for a dense MLP."""
    h = L.norm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = M.moe_fwd(p["moe"], cfg, h, dispatch=dispatch,
                           drop_free=drop_free, capacity=capacity)
        return x + y, aux
    mlp = L.gelu_mlp if "b_up" in p["mlp"] else L.swiglu
    return x + mlp(p["mlp"], h, d_ff=SH.dense_ff(cfg)), None


def _ln1(p, cfg, x, x_extra):
    """Pre-norm input; zamba2's shared block norms concat(x, x_extra)."""
    if x_extra is not None:
        x = torch.cat([x, x_extra], dim=-1)
    return L.norm(p["ln1"], x, cfg.norm_eps)


def _attn_block_fwd(p, cfg, x, positions, *, window, mode, x_extra=None,
                    moe=None, causal=True, rope=True, enc_out=None):
    """Pre-norm residual attention + MLP block over a full sequence.
    ``moe``: ``_ffn``'s routing keywords.  ``enc_out`` (whisper's
    decoder): the cross-attention on the encoder's output after the
    self-attention, through the flash kernel at Sq = S text positions
    against Skv = F frames (non-causal, no rotary; the reference runs it
    in flash mode whatever ``mode`` is).  Returns (x, aux, kv) with kv
    (k, v), (ckv, k_rope) for MLA, or (k, v, xk, xv) with the cross
    K/V."""
    h = _ln1(p, cfg, x, x_extra)
    if cfg.mla is not None:
        a, kv = A.mla_fwd(p["attn"], cfg, h, positions, mode=mode,
                          return_cache=True)
    else:
        a, kv = A.attention_fwd(p["attn"], cfg, h, positions, causal=causal,
                                window=window, mode=mode, rope=rope,
                                return_kv=True)
    x = x + a
    if enc_out is not None:
        ca, ckv = A.attention_fwd(p["xattn"], cfg,
                                  L.norm(p["ln_x"], x, cfg.norm_eps), None,
                                  causal=False, rope=False, xkv=enc_out,
                                  return_kv=True)
        x = x + ca
        kv = (*kv, *ckv)
    x, aux = _ffn(p, cfg, x, **(moe or {}))
    return x, aux, kv


def _cross_decode(p, cfg, q_in, xk, xv):
    """Cross-attention decode against the static encoder K/V (B, F, Hkv,
    D): the contiguous decode kernel over all F frames (the reference
    runs ``chunked_attention`` there, non-causal over the whole cross
    cache).  On a mesh the weights compute the rank's heads (``w_o``
    row-parallel) and the cache is the rank's slice by the reference's
    rule: where it holds every head, the heads' q are gathered first;
    where its frames are cut over the "seq" axes, the kernel runs on
    the rank's frames with its log-sum-exp and the ranks' partials are
    merged (``attention.merge_partials``), as self-attention's
    sequence-cut decode does."""
    B = q_in.shape[0]
    hd = cfg.resolved_head_dim
    q = q_in @ p["w_q"]
    if "b_q" in p:
        q = q + p["b_q"]
    q = q.reshape(B, -1, hd)
    H_w = q.shape[1]
    heads = None
    if xk.shape[2] == cfg.n_kv_heads and H_w != cfg.n_heads:
        heads = L.tp_axis(H_w, cfg.n_heads)
        q = heads[0].gather(q, 1, heads[1])
    F_loc = xk.shape[1]
    if F_loc == cfg.n_audio_frames:
        o = ops.decode_attention(q, xk, xv, F_loc)
    else:
        mesh = PS.current_mesh()
        seq = PS.entry_of("seq", cfg.n_audio_frames // F_loc)
        o, lse = ops.decode_attention(q, xk, xv, F_loc, return_lse=True)
        o = A.merge_partials(o, lse, mesh, seq)
    if heads is not None:                     # back to the rank's heads
        o = o.narrow(1, heads[0].index(heads[1]) * H_w, H_w)
    return A._out_proj(p, cfg, o.reshape(B, 1, -1))


def _attn_block_decode(p, cfg, x, cache: dict, pos, *, window,
                       x_extra=None, block_tables=None, rope=True,
                       rope_pos=None):
    """One decode step of the block against its layer's cache (``k``/``v``
    or MLA's ``ckv``/``krope`` views, written in place): contiguous
    rows, or the paged pool read through ``block_tables``; then, for
    whisper's decoder (``xattn`` in the tree), the cross-attention on
    the layer's static ``xk``/``xv``.  ``rope`` / ``rope_pos``: see
    ``attention_decode``.  MoE routing is drop-free, as on every serving
    path."""
    h = _ln1(p, cfg, x, x_extra)
    if cfg.mla is not None:
        fn = A.mla_decode if block_tables is None else A.mla_paged_decode
        args = (cache["ckv"], cache["krope"], pos)
        kw = {}
    elif block_tables is not None:
        fn = A.paged_attention_decode
        args = (cache["k"], cache["v"], pos)
        kw = dict(window=window)
    else:
        fn = A.attention_decode
        args = (cache["k"], cache["v"], pos)
        kw = dict(window=window, rope=rope, rope_pos=rope_pos)
    if block_tables is not None:
        args += (block_tables,)
    a, _, _ = fn(p["attn"], cfg, h, *args, **kw)
    x = x + a
    if "xattn" in p:                           # whisper: static cross cache
        x = x + _cross_decode(p["xattn"], cfg,
                              L.norm(p["ln_x"], x, cfg.norm_eps),
                              cache["xk"], cache["xv"])
    return _ffn(p, cfg, x)[0]


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
            def block(x, lp=lp, name=name):
                return _attn_block_fwd(L.gathered(lp, (name,)), cfg, x,
                                       positions, window=window, mode=mode,
                                       moe=moe)
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


def _mamba_stack(layers, cfg, x, return_cache, remat, prefix):
    """Run the Mamba2 blocks ``layers`` (per-block param dicts of the
    stack ``prefix``, each read through ``layers.gathered``) as
    residuals; returns (x, their states in order)."""
    states = []
    for lp in layers:
        if return_cache:
            y, st = SSM.mamba2_fwd(L.gathered(lp, prefix), cfg, x,
                                   return_state=True)
            states.append(st)
            x = x + y
        else:
            x = _block(lambda x, lp=lp: x + SSM.mamba2_fwd(
                L.gathered(lp, prefix), cfg, x), remat)(x)
    return x, states


def _zamba_forward(params, cfg, x, positions, *, mode, window,
                   return_cache, remat):
    """The twin of the reference's ``_zamba_forward``: ``units`` times
    k_every Mamba2 blocks then the shared attention block on
    concat(x, embedding) through its per-unit adapter, then the tail.
    With ``remat`` under autograd each Mamba2 block and each application
    of the shared block is recomputed in the backward.  On a mesh each
    block reads its weights through ``layers.gathered``."""
    emb0 = x                                   # original embedding stream
    units, k, tail = _hybrid_layout(cfg)
    mamba_sts, ks, vs = [], [], []
    adapters = torch.unbind(params["shared_adapters"])
    for unit, adapter in zip(_stack_layers(params["mamba_units"], (units, k)),
                             adapters):
        x, sts = _mamba_stack(unit, cfg, x, return_cache, remat,
                              ("mamba_units",))
        y, _, (kk, vv) = _block(
            lambda x: _attn_block_fwd(
                L.gathered(params["shared_attn"], ("shared_attn",)), cfg, x,
                positions, window=window, mode=mode, x_extra=emb0),
            remat)(x)
        x = x + (y - x) @ L.gathered(adapter, ("shared_adapters",))
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
                              cfg, x, return_cache, remat, ("mamba_tail",))
        if return_cache:
            cache["mamba_tail"] = _stack_states(sts, (tail,))
    return x, cache


def _xlstm_forward(params, cfg, x, *, return_cache, remat):
    """The twin of the reference's ``_xlstm_forward``: ``units`` times
    ``per`` mLSTM blocks then one sLSTM block, each with its own
    residual; with ``remat`` under autograd each block is recomputed in
    the backward.  On a mesh each block reads its weights through
    ``layers.gathered``."""
    units, per = _xlstm_layout(cfg)
    msts, ssts = [], []
    for mlayers, sp in zip(_stack_layers(params["mlstm_units"], (units, per)),
                           _stack_layers(params["slstm_units"], (units,))):
        for lp in mlayers:
            if return_cache:
                x, st = X.mlstm_block_fwd(L.gathered(lp, ("mlstm_units",)),
                                          cfg, x, return_state=True)
                msts.append(st)
            else:
                x = _block(lambda x, lp=lp: X.mlstm_block_fwd(
                    L.gathered(lp, ("mlstm_units",)), cfg, x), remat)(x)
        if return_cache:
            x, st = X.slstm_block_fwd(L.gathered(sp, ("slstm_units",)), cfg,
                                      x, return_state=True)
            ssts.append(st)
        else:
            x = _block(lambda x, sp=sp: X.slstm_block_fwd(
                L.gathered(sp, ("slstm_units",)), cfg, x), remat)(x)
    cache = None
    if return_cache:
        cache = {"mlstm_units": _stack_states(msts, (units, per)),
                 "slstm_units": _stack_states(ssts, (units,))}
    return x, cache


def mrope_positions(cfg: ModelConfig, B: int, n_patches: int, s_text: int,
                    offset: int = 0, device="cpu") -> torch.Tensor:
    """Qwen2-VL's M-RoPE position triples (3, B, P + S) int32 for
    [patches | text]: patch i at (0, i // grid, i % grid) on a grid of
    ``int(sqrt(P)) or 1``, then text position j at grid + j in all
    three streams; plus ``offset``."""
    grid = int(n_patches ** 0.5) or 1
    pi = torch.arange(n_patches, dtype=torch.int32, device=device)
    ti = grid + torch.arange(s_text, dtype=torch.int32, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(pi), ti]),
                       torch.cat([pi // grid, ti]),
                       torch.cat([pi % grid, ti])])          # (3, S)
    return (pos[:, None, :] + offset).expand(3, B, pos.shape[-1])


def _side_input(batch: dict, key: str, cfg: ModelConfig) -> torch.Tensor:
    if key not in batch:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                         f"batch[{key!r}]")
    return batch[key]


def _whisper_forward(params, cfg, batch, *, mode, return_cache, remat):
    """The twin of the reference's ``_whisper_forward``.  Encoder: the
    frames (B, F, d) plus the sinusoidal table, non-causal self-attention
    without rotary, LayerNorm ``enc_ln``.  Decoder: token embeddings plus
    the learned ``dec_pos[:S]``, causal self-attention without rotary,
    then cross-attention on the encoder's output.  Returns (hidden
    (B, S, d) before the final norm, cache ``{"dec": {k, v, xk, xv}}``
    or None).  With ``remat`` under autograd each block is recomputed in
    the backward."""
    frames = _side_input(batch, "audio_frames", cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > params["dec_pos"].shape[0]:
        raise ValueError(f"{cfg.name}: {S} decoder positions exceed the "
                         f"{params['dec_pos'].shape[0]} of dec_pos")
    dt = L.dtype_of(cfg.activation_dtype)
    enc = frames.to(dt) + L.sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(dt)[None]
    for lp in _unbind_params(params["enc_blocks"], cfg.n_encoder_layers):
        enc = _block(lambda x, lp=lp: _attn_block_fwd(
            L.gathered(lp, ("enc_blocks",)), cfg, x, None, window=0,
            mode=mode, causal=False, rope=False)[0], remat)(enc)
    enc = L.layernorm(params["enc_ln"], enc, cfg.norm_eps)
    x = (L.embed(L.gathered(params["embed"], ("embed",)), tokens,
                 cfg.vocab_size)
         + params["dec_pos"][None, :S].to(dt))
    kvs = []
    grad = remat and torch.is_grad_enabled()
    for lp in _unbind_params(params["dec_blocks"], cfg.n_layers):
        def block(x, enc, lp=lp):
            y, _, kv = _attn_block_fwd(L.gathered(lp, ("dec_blocks",)), cfg,
                                       x, None, window=0, mode=mode,
                                       rope=False, enc_out=enc)
            return y, kv
        x, kv = (checkpoint(block, x, enc, use_reentrant=False) if grad
                 else block(x, enc))
        if return_cache:
            kvs.append(kv)
    cache = None
    if return_cache:
        cache = {"dec": {leaf: torch.stack([kv[j] for kv in kvs])
                         for j, leaf in enumerate(("k", "v", "xk", "xv"))}}
    return x, cache


def _forward_hidden(params, cfg, batch, *, mode, window, return_cache,
                    moe, remat=False):
    """The layer stack over ``batch["tokens"]`` (B, S) and the family's
    side input (audio: ``audio_frames`` (B, F, d); vlm: ``patch_embeds``
    (B, P, d), put ahead of the text): hidden states after the last
    block, the summed MoE aux and the cache its prefill leaves (dense,
    vlm and moe: per-layer k/v or MLA latents per stack; hybrid: the
    zamba2 tree; ssm: the xLSTM states; audio: the decoder's self and
    cross K/V)."""
    window = window or cfg.sliding_window
    tokens = batch["tokens"]
    B, S = tokens.shape
    zero = torch.zeros((), dtype=F32, device=params["embed"].device)
    if cfg.family == "audio":
        x, cache = _whisper_forward(params, cfg, batch, mode=mode,
                                    return_cache=return_cache, remat=remat)
        return x, zero, cache
    x = L.embed(L.gathered(params["embed"], ("embed",)), tokens,
                cfg.vocab_size)
    if cfg.family == "vlm":
        pe = _side_input(batch, "patch_embeds", cfg).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        positions = mrope_positions(cfg, B, pe.shape[1], S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
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
            mode: str = "flash", moe_dispatch: str = "einsum",
            moe_drop_free: bool = False, moe_capacity=None, window: int = 0,
            return_cache: bool = False, return_hidden: bool = False,
            remat: bool = True):
    """Returns (logits (B, S, V) fp32, aux [, cache][, hidden]).
    ``batch["tokens"]``: (B, S) int32; audio also takes
    ``batch["audio_frames"]`` (B, F, d), vlm ``batch["patch_embeds"]``
    (B, P, d), whose P positions come first (logits (B, P + S, V)).
    With ``return_cache`` the cache
    has ``init_cache``'s tree with batch B and sequence S (vlm: P + S),
    ready for ``graft_slot_cache``.  Attention runs the flash kernel
    (``mode="flash"``) once per layer (hybrid: once per unit; MLA at q/k
    head dim 192 and v head dim 128 at deepseek's widths; whisper once
    per encoder layer and twice per decoder layer, the cross-attention
    at Sq = S against Skv = F), and every
    Mamba2 block the SSD scan kernel once; the xLSTM blocks run no
    kernel.

    ``moe_dispatch``: the MoE's ``"einsum"`` or ``"scatter"`` dispatch
    (``moe.moe_fwd``).  aux: 0 for dense and hybrid; for moe the summed
    load-balance loss,
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
    moe = dict(drop_free=moe_drop_free, capacity=moe_capacity,
               dispatch=moe_dispatch)
    x, aux, cache = _forward_hidden(params, cfg, batch, mode=mode,
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
    p = L.gathered(params["mtp"], ("mtp",))
    B, S = tokens.shape
    h = L.rmsnorm(p["norm_h"], hidden[:, :S - 2], cfg.norm_eps)
    e = L.rmsnorm(p["norm_e"], L.embed(
        L.gathered(params["embed"], ("embed",)), tokens[:, 1:S - 1],
        cfg.vocab_size), cfg.norm_eps)
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


def _batch_mean(x, mask=None):
    """The mean of ``x`` (over ``mask`` when given, at least one) over the
    whole batch: on a training mesh each rank holds its rows, so the
    numerator and the denominator are summed over the batch cut apart
    (``layers.batch_sum``)."""
    if not PS.batch_axes():
        if mask is None:
            return x.mean()
        return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    num = x.sum() if mask is None else (x * mask).sum()
    den = (torch.tensor(float(x.numel()), device=x.device) if mask is None
           else mask.sum())
    tot = L.batch_sum(torch.stack([num, den.to(num.dtype)]))
    return tot[0] / torch.clamp_min(tot[1], 1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", moe_dispatch: str = "einsum",
            remat: bool = True):
    """Next-token cross-entropy (over ``batch["loss_mask"][:, 1:]`` when
    given; vlm: over the text positions only) + the summed MoE
    load-balance aux + the MTP loss when the
    config carries an MTP head (deepseek-v3).  Returns (total, metrics)
    with metrics {"loss", "aux_loss", "mtp_loss", "perplexity"}, 0-d
    tensors.  On a training mesh (rules with a cut batch installed)
    ``batch`` is this rank's rows and every metric is the whole batch's,
    the same on every rank; ``total``'s gradient is this rank's share,
    which the step sums over the ranks."""
    tokens = batch["tokens"]
    mtp_loss = torch.zeros((), dtype=F32, device=tokens.device)
    if cfg.use_mtp:
        logits, aux, hidden = forward(params, cfg, batch, mode=mode,
                                      moe_dispatch=moe_dispatch,
                                      return_hidden=True, remat=remat)
        ml = mtp_logits(params, cfg, hidden, tokens, mode=mode)
        mtp_loss = cfg.mtp_weight * _batch_mean(_token_nll(ml, tokens[:, 2:]))
    else:
        logits, aux = forward(params, cfg, batch, mode=mode,
                              moe_dispatch=moe_dispatch, remat=remat)
    if cfg.family == "vlm":
        logits = logits[:, -tokens.shape[1]:]      # text tail only
    nll = _token_nll(logits[:, :-1], tokens[:, 1:])
    mask = batch.get("loss_mask")
    loss = _batch_mean(nll, None if mask is None else mask[:, 1:].to(F32))
    total = loss + aux + mtp_loss
    return total, {"loss": loss, "aux_loss": aux, "mtp_loss": mtp_loss,
                   "perplexity": torch.exp(torch.clamp_max(loss, 20.0))}


@torch.no_grad()
def prefill(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", moe_dispatch: str = "einsum",
            moe_capacity=None, return_aux: bool = False, max_seq=None):
    """Run the full prompt (MoE routing drop-free through
    ``moe_dispatch``, under ``moe_capacity`` if given), returning
    (last-position logits (B, 1, V), cache), or (logits, aux, cache)
    with ``return_aux`` (aux: the overflow count
    under ``moe_capacity``, see ``forward``).  Only the last position is
    unembedded: the JAX function computes every position's logits and
    slices the last.  The cache holds the prompt's S positions, or with
    ``max_seq`` an ``init_cache(cfg, B, max_seq)`` layout with the
    prompt at its slots (whisper's cross cache keeps its frames; vlm's
    positions count the patches).  On a mesh (rules installed,
    ``launch.steps.make_prefill_step``) it is the rank's slice by the
    reference's rule (``launch.sharding.rank_cache``), which
    ``decode_step`` takes."""
    moe = dict(drop_free=True, capacity=moe_capacity, dispatch=moe_dispatch)
    x, aux, cache = _forward_hidden(params, cfg, batch, mode=mode,
                                    window=0, return_cache=True, moe=moe)
    if max_seq is not None or PS.current_mesh() is not None:
        cache = SH.rank_cache(cfg, cache, max_seq)
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
    """The twin of the reference's ``_zamba_decode``; on a mesh each
    block reads its weights through ``layers.gathered``."""
    emb0 = x
    units, k, tail = _hybrid_layout(cfg)
    mp, mc, ac = params["mamba_units"], cache["mamba_units"], \
        cache["shared_attn"]
    shared = L.gathered(params["shared_attn"], ("shared_attn",))
    for u in range(units):
        for j in range(k):
            x = x + _step_in_place(
                SSM.mamba2_decode, L.gathered(layer_params(mp, u, j),
                                              ("mamba_units",)),
                cfg, x, mc, (u, j))
        y = _attn_block_decode(shared, cfg, x, _layer_cache(ac, u), pos,
                               window=window, x_extra=emb0)
        x = x + (y - x) @ L.gathered(params["shared_adapters"][u],
                                     ("shared_adapters",))
    for i in range(tail):
        x = x + _step_in_place(
            SSM.mamba2_decode, L.gathered(layer_params(
                params["mamba_tail"], i), ("mamba_tail",)),
            cfg, x, cache["mamba_tail"], (i,))
    return x


def _xlstm_decode(params, cfg, x, cache):
    """The twin of the reference's ``_xlstm_decode``; on a mesh each
    block reads its weights through ``layers.gathered``."""
    units, per = _xlstm_layout(cfg)
    for u in range(units):
        for j in range(per):
            x = _step_in_place(
                X.mlstm_block_decode, L.gathered(layer_params(
                    params["mlstm_units"], u, j), ("mlstm_units",)), cfg,
                x, cache["mlstm_units"], (u, j))
        x = _step_in_place(
            X.slstm_block_decode, L.gathered(layer_params(
                params["slstm_units"], u), ("slstm_units",)), cfg, x,
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
    drop-free.  On a mesh whose rules carry a read plan (FSDP cuts,
    ``launch.steps.make_serve_step``) each layer's weights are gathered
    where they are read, as in ``forward``.  Audio adds the learned
    position ``dec_pos[pos]`` (a scalar pos only, below dec_pos's
    length; per-slot positions raise, as in the reference) and attends the static cross cache; vlm's
    rotary position is ``pos - cfg.n_patches + grid`` (the text restarts
    after the patch grid of ``cfg.n_patches``, whatever patch count the
    prompt had, as in the reference).  Returns (logits (B, 1, V) fp32,
    cache) with the cache written in place."""
    if block_tables is not None:
        require_paged(cfg, "decode_step")
    window = cfg.sliding_window
    x = L.embed(L.gathered(params["embed"], ("embed",)), tokens,
                cfg.vocab_size)
    if cfg.family == "audio":
        if torch.as_tensor(pos).dim() == 1:
            raise NotImplementedError(
                "per-slot decode positions unsupported for encoder-decoder "
                "audio (learned positions are looked up with a scalar "
                "index)")
        n_pos = params["dec_pos"].shape[0]
        at = torch.as_tensor(pos, dtype=torch.long, device=x.device)
        if not at.is_meta and not 0 <= int(pos) < n_pos:
            raise ValueError(f"{cfg.name}: decode position {int(pos)} is "
                             f"outside dec_pos's {n_pos} positions")
        x = x + params["dec_pos"].index_select(0, at.reshape(1))[None]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if cfg.family == "hybrid":
        x = _zamba_decode(params, cfg, x, cache, pos, window)
    elif cfg.family == "ssm":
        x = _xlstm_decode(params, cfg, x, cache)
    else:
        kw = {}
        if cfg.family == "audio":
            stacks, kw = (("dec_blocks", cfg.n_layers),), dict(rope=False)
        else:
            stacks = attn_stacks(cfg)
        if cfg.family == "vlm":
            # M-RoPE: the slot index pos counts [patches | text]; the
            # text's rotary positions restart after the patch grid
            grid = int(cfg.n_patches ** 0.5) or 1
            kw = dict(rope_pos=pos - cfg.n_patches + grid)
        for name, n in stacks:
            cname = "dec" if cfg.family == "audio" else name
            for i in range(n):
                lp = L.gathered(layer_params(params[name], i), (name,))
                x = _attn_block_decode(
                    lp, cfg, x,
                    _layer_cache(cache[cname], i), pos, window=window,
                    block_tables=block_tables, **kw)
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
    require_paged(cfg, "prefill_chunk")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens, cfg.vocab_size)
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
