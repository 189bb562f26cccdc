"""Model assembly for the dense family: the twin of the JAX package's
``models/transformer.py`` on the serving paths.

    params          = init_params(cfg, seed=0, device="cuda")
    # contiguous cache (fixed-slot engine, contiguous SlotManager)
    cache           = init_cache(cfg, B, max_seq, device)
    logits, _, pcache = forward(params, cfg, {"tokens": t},
                                return_cache=True)
    cache           = graft_slot_cache(cache, pcache, slot)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos)
    # paged pool (continuous engine)
    cache           = init_paged_cache(cfg, n_pages, page_size, device)
    logits, _, cache = prefill_chunk(params, cfg, cache, tokens, n_valid,
                                     pos_offset, block_tables)
    logits, cache   = decode_step(params, cfg, cache, tokens, pos,
                                  block_tables=block_tables)

Params keep the JAX tree paths (``embed``, ``final_norm/scale``,
``blocks/{ln1,attn,ln2,mlp}/...`` with a leading layer axis), so
``repro_torch.bridge`` maps a JAX params tree leaf for leaf.  The
``jax.lax.scan`` over layers is a Python loop over views of the stacked
tensors.  Caches and pools are updated in place (see
``models.attention``).  Everything here is inference: it runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

F32 = torch.float32


def require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense" or cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet (dense only)")


# ==========================================================================
# init
# ==========================================================================

def _trunc_normal(shape, gen, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], by inverting the CDF."""
    lo = 0.5 * (1 + math.erf(-3 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen, device=device, dtype=F32)
    u = lo + (1 - 2 * lo) * u
    return torch.erfinv(2 * u - 1) * math.sqrt(2)


def _dense_init(shape, dtype, gen, device) -> torch.Tensor:
    """Truncated-normal fan-in init; ``shape`` has a leading layer axis
    for stacked params (fan-in is then ``shape[1]``), as the JAX
    ``dense_init`` under ``vmap`` sees it."""
    fan_in = shape[-2]
    return (_trunc_normal(shape, gen, device) / fan_in ** 0.5).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random params in the JAX package's layout, drawn from a seeded
    ``torch.Generator`` on ``device`` (they are NOT the JAX package's
    numbers: parity tests load those through ``bridge``)."""
    require_dense(cfg, "init_params")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = L.dtype_of(cfg.param_dtype)
    Lyr, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    H, Hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dense = lambda *shape: _dense_init(shape, dt, gen, dev)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)  # noqa: E731
    p = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
                  * 0.02).to(dt),
        "final_norm": {"scale": ones(d)},
        "blocks": {
            "ln1": {"scale": ones(Lyr, d)},
            "attn": {"w_q": dense(Lyr, d, H * hd),
                     "w_k": dense(Lyr, d, Hkv * hd),
                     "w_v": dense(Lyr, d, Hkv * hd),
                     "w_o": dense(Lyr, H * hd, d)},
            "ln2": {"scale": ones(Lyr, d)},
            "mlp": {"w_gate": dense(Lyr, d, ff),
                    "w_up": dense(Lyr, d, ff),
                    "w_down": dense(Lyr, ff, d)},
        },
    }
    if cfg.qkv_bias:
        p["blocks"]["attn"].update(
            b_q=torch.zeros((Lyr, H * hd), dtype=dt, device=dev),
            b_k=torch.zeros((Lyr, Hkv * hd), dtype=dt, device=dev),
            b_v=torch.zeros((Lyr, Hkv * hd), dtype=dt, device=dev))
    if cfg.qk_norm:
        p["blocks"]["attn"].update(q_norm={"scale": ones(Lyr, hd)},
                                   k_norm={"scale": ones(Lyr, hd)})
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(d, cfg.vocab_size)
    return p


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params as views into the stacked tensors."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def init_cache(cfg: ModelConfig, B: int, max_seq: int,
               device="cuda") -> dict:
    """Zero contiguous KV cache ``{"blocks": {"k", "v"}}`` with leaves
    (L, B, S_cache, Hkv, D) in the activation dtype: S_cache is max_seq,
    or the ring length ``min(max_seq, sliding_window)`` for
    sliding-window archs."""
    require_dense(cfg, "init_cache")
    dev = resolve_device(device)
    S_c = (min(max_seq, cfg.sliding_window) if cfg.sliding_window
           else max_seq)
    shape = (cfg.n_layers, B, S_c, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = L.dtype_of(cfg.activation_dtype)
    return {"blocks": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


def _batch_axis_slices(big: torch.Tensor, small_shape, slot: int):
    """Index of the region ``small_shape`` covers in ``big`` at ``slot``:
    the batch axis is the first axis where the shapes differ, and any
    later mismatch (the shorter sequence axis) starts at 0."""
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
    engine's block tables."""
    require_dense(cfg, "init_paged_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    dt = L.dtype_of(cfg.activation_dtype)
    return {"blocks": {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


def _lm_logits(params, cfg, x):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, transpose=True)
    return L.unembed(params["lm_head"], x, transpose=False)


def _mlp(p, cfg, x):
    h = L.norm(p["ln2"], x, cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h)


# ==========================================================================
# forward (monolithic prefill)
# ==========================================================================

def _forward_hidden(params, cfg, tokens, *, mode, window, return_cache):
    """The layer stack over ``tokens`` (B, S): hidden states after the
    last block, and the per-layer k/v stacked as a contiguous cache."""
    require_dense(cfg, "forward")
    window = window or cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["blocks"], i)
        h = L.norm(lp["ln1"], x, cfg.norm_eps)
        a, (k, v) = A.attention_fwd(lp["attn"], cfg, h, positions,
                                    window=window, mode=mode, return_kv=True)
        if return_cache:
            ks.append(k)
            vs.append(v)
        x = _mlp(lp, cfg, x + a)
    cache = ({"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
             if return_cache else None)
    return x, cache


@torch.no_grad()
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            mode: str = "flash", window: int = 0,
            return_cache: bool = False):
    """Returns (logits (B, S, V) fp32, aux_loss (0: dense)[, cache]).
    ``batch["tokens"]``: (B, S) int32.  With ``return_cache`` the cache
    is ``{"blocks": {"k", "v"}}`` with leaves (L, B, S, Hkv, D), ready
    for ``graft_slot_cache``.  Attention runs the flash kernel
    (``mode="flash"``) once per layer."""
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

@torch.no_grad()
def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, pos,
                block_tables=None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) int32.  pos: an int or 0-d
    tensor (every sequence at the same position: the fixed-slot engine)
    or a (B,) int32 tensor of per-sequence write positions (continuous
    batching).  block_tables: None for a contiguous ``init_cache``
    cache, else (B, max_pages) int32 page ids into an
    ``init_paged_cache`` pool (scratch page 0 for idle slots and unused
    entries; pos must then be (B,)).  Returns (logits (B, 1, V) fp32,
    cache) with the cache written in place."""
    require_dense(cfg, "decode_step")
    window = cfg.sliding_window
    x = L.embed(params["embed"], tokens)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    blocks, kv = params["blocks"], cache["blocks"]
    for i in range(cfg.n_layers):
        lp = layer_params(blocks, i)
        h = L.norm(lp["ln1"], x, cfg.norm_eps)
        if block_tables is None:
            a, _, _ = A.attention_decode(lp["attn"], cfg, h, kv["k"][i],
                                         kv["v"][i], pos, window=window)
        else:
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
    paged pool.  tokens: (1, C) int32, chunk positions
    ``[pos_offset, pos_offset + C)`` of which the first ``n_valid`` are
    real (pads write to the scratch page).  block_tables: (1, max_pages)
    int32 covering positions [0, pos_offset + n_valid).

    Returns (logits (1, C, V) fp32, moe_overflow (0: dense), cache).
    ``logits[0, i]`` is the next-token distribution after position
    ``pos_offset + i``; admission reads ``logits[0, n_valid - 1]`` and
    speculative verify reads every position."""
    require_dense(cfg, "prefill_chunk")
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
