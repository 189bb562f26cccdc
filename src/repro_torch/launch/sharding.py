"""Sharding rules over the port's param and cache trees, and each rank's
slices of them: the twin of the JAX package's ``launch/sharding.py``.

The rule functions (``param_logical_axes``, ``cache_logical_axes``,
``paged_cache_logical_axes``, ``batch_pspecs`` and the ``*_pspecs``
tree functions) are the reference's, over nested dicts whose leaves
carry the reference's tree paths (``bridge`` loads by path), with
``models.pspec``'s tuples for ``PartitionSpec``s.

Where the reference lets GSPMD place every tensor from those specs,
the port cuts each rank's slices itself (``shard_params``,
``pool_cut``) and joins the ranks with explicit collectives, so the
placement must keep every rank's compute whole:

  * KV pools follow ``paged_cache_logical_axes`` exactly: k/v pools
    (L, n_pages, page_size, Hkv, D) cut on their KV heads, MLA latent
    pools (L, n_pages, page_size, rank) on the latent rank (``ckv``)
    and the rotary width (``krope``); the layer, page and offset axes
    are never cut, and a count that does not divide replicates.  So a
    page id names the same page on every rank and the allocator's
    ledger is every rank's.
  * Attention follows whole heads: q/k/v project onto the rank's
    ``Hkv / n`` KV heads and their ``H / n`` query heads, their biases
    with them, ``w_o`` row-parallel (one ``all_reduce``).  When the KV
    heads do not divide, attention replicates: the reference's generic
    rule would cut inside a head (``w_k``'s 5 x 64 columns over 4),
    which GSPMD hides and manual tensor parallelism cannot.
  * MLA: ``w_uk`` and ``w_uv`` cut their rows by the latent rank, as
    the pool is; the contractions over the rank are partial sums joined
    by ``all_reduce`` (the scores before the softmax, the value
    up-projection after).  The query and latent down-projections and
    ``w_o`` replicate.
  * MLPs: ``w_gate``/``w_up`` (and ``b_up``) split ``d_ff``, ``w_down``
    row-parallel (one ``all_reduce``; ``b_down`` added once after it);
    the MoE's shared expert likewise.
  * ``embed`` and ``lm_head`` are vocab-parallel: a masked local lookup
    joined exactly, and local logits gathered exactly
    (``ServingMesh.combine``).
  * Experts split over "expert" (``E / n`` a rank); routers, norms and
    every other leaf replicate.
  * Mamba2 blocks (zamba2) follow whole SSM heads: ``in_proj`` packs
    z | x | B | C | dt in its columns, and the rank holds its heads'
    columns of z, x and dt and the B and C columns whole (one group,
    which every head reads; ``PackedCut``); ``out_proj`` is
    row-parallel; ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``
    and the norm's scale replicate, as the reference's rule has them,
    and each rank reads its heads' share (``models.ssm``).  The norm
    over the whole ``d_inner`` sums the ranks' squares (one
    all-reduce).  The adapters of zamba2's shared block replicate over
    "model" (the reference cuts their output columns).
  * xLSTM blocks follow whole heads, as Mamba2 blocks do.  mLSTM:
    ``w_up`` packs main | z in its columns, each part cut by the rank's
    heads (``PackedCut``); ``w_q``, ``w_k`` and ``w_v`` (nh, dh, dh) on
    their head dim; ``w_if`` row-parallel on the rank's channels (every
    head's gates read all of ``x_main``: the (B, S, 2 nh) partials are
    summed in one fp32 all-reduce, 2 nh a token where a gathered
    ``x_main`` would cross d_inner); ``w_down`` row-parallel.  sLSTM:
    ``w_gates`` packs z | i | f | o, each stream cut by the rank's
    heads; the block's input and its conv stay whole; its SwiGLU ``up``
    reads the heads' outputs gathered whole and is cut on its ``d_ff``
    as every MLP is, where the count divides (else it replicates).
    ``conv_w``, ``conv_b``, ``skip``, ``b_if``, ``r_gates``,
    ``b_gates`` and the per-head norm's scale replicate, as the
    reference's rule has them, and each rank reads its heads' share
    (``models.xlstm``).  The recurrent state follows the heads
    (``_cache_cuts``).
  * A contiguous cache follows the reference's ``cache_logical_axes``
    exactly: k/v (L, B, S, Hkv, hd) cut on the batch over "batch" and,
    where the KV heads divide 16, on the heads over "model" (as the
    weights' heads), else on the positions over "seq" (an MQA cache:
    decode merges the ranks' partial softmaxes,
    ``models.attention.attention_decode``); MLA's ckv/krope on the
    latent rank and rotary width; whisper's cross cache ``xk``/``xv``
    as k/v (its frames over "seq"); the Mamba2 state ``ssm`` on its
    heads.  One departure: the Mamba2 ``conv`` window's channels x | B
    | C are cut as ``conv_w``'s, the x channels by the rank's heads, B
    and C whole (the reference cuts them evenly, across the parts).
    The xLSTM state departs too: every leaf keeps its rows cut by
    "batch" on its row dim, and mLSTM's ``C``, ``n``, ``m`` and sLSTM's
    ``c``, ``n``, ``m`` the rank's heads, mLSTM's ``conv`` and sLSTM's
    ``h`` the rank's heads' channels (the rule cuts ``C`` and ``n`` on
    their key dim, sLSTM's ``n`` on its head dim, and puts "batch" on
    sLSTM's ``m``'s heads); sLSTM's ``conv_win`` stays whole.
    ``shard_cache`` cuts a whole cache, ``rank_cache`` a prefill's.

Every count comes from ``models.pspec.shard_count`` under the installed
rules, so a logical map that sends "model" nowhere replicates all.  A
cut's mesh axes are the logical name's under the installed map, as far
as the count divides (``models.pspec.entry_of``): "model" under the
serving map, ``baseline`` and ``infer-tp``, both axes or "data" under
``infer-tp2``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import pspec as PS
from repro_torch.tree import (tree_leaves_with_path, tree_map,
                              tree_map_with_path)

# Sharding presets, as in the reference:
#   baseline  — TP over "model" + FSDP over "data", batch over (pod, data)
#   dp        — pure data parallel: batch over every axis, params FSDP
#               over "data" only
#   infer-tp  — serving: params TP over "model", replicated over "data"
#   ep        — one expert per chip (experts over data x model)
#   infer-tp2 — serving for giant MoE: TP over both axes
SHARDING_PRESETS = {
    "baseline": None,
    "dp": {
        "batch": ("pod", "data", "model"),
        "fsdp": ("data",),
        "model": (),
        "expert": ("model",),
        "seq": (),
    },
    "infer-tp": {
        "batch": ("pod", "data"),
        "fsdp": (),
        "model": ("model",),
        "expert": ("model",),
        "seq": ("model",),
    },
    "ep": {
        "batch": ("pod", "data"),
        "fsdp": ("data",),
        "model": ("model",),
        "expert": ("data", "model"),
        "seq": ("model",),
    },
    "infer-tp2": {
        "batch": ("pod",),
        "fsdp": (),
        "model": ("data", "model"),
        "expert": ("data", "model"),
        "seq": (),
    },
}

# The continuous engine's mesh: params tensor-parallel over "model",
# experts expert-parallel over "model", no FSDP; "batch" and "seq" stay
# replicated (slots are few, and the page axis carries block-table
# semantics no mesh axis may cut).
SERVING_LOGICAL_MAP = {
    "batch": (),
    "fsdp": (),
    "model": ("model",),
    "expert": ("model",),
    "seq": (),
}

# weights whose LAST dim is the contraction output fed back to d_model
_DOWN_STYLE = ("w_o", "w_down", "out_proj")
_REPLICATED = ("A_log", "D", "dt_bias", "b_if", "b_gates", "conv_w", "conv_b",
               "scale", "bias", "b_q", "b_k", "b_v", "b_up", "b_down",
               "router", "skip", "r_gates")


def _path_names(path) -> list:
    return [str(e) for e in path]


def _ndim(leaf) -> int:
    return leaf.ndim if hasattr(leaf, "ndim") else len(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


# ==========================================================================
# the reference's rules
# ==========================================================================

def param_logical_axes(path, leaf) -> list:
    """The logical axis names of one parameter leaf (a tensor, or a
    shape)."""
    names = _path_names(path)
    last = names[-1] if names else ""
    nd = _ndim(leaf)
    if last in _REPLICATED or nd <= 1:
        return [None] * nd
    if last == "embed":
        return [None] * (nd - 2) + ["model", "fsdp"]      # (vocab, d)
    if last in ("lm_head",):
        return [None] * (nd - 2) + ["fsdp", "model"]      # (d, vocab)
    if last == "dec_pos":
        return [None] * nd
    in_moe = "moe" in names and last in ("w_gate", "w_up", "w_down")
    if in_moe:
        core = (["expert", None, "fsdp"] if last == "w_down"
                else ["expert", "fsdp", None])
        return [None] * (nd - 3) + core
    if last in _DOWN_STYLE:
        return [None] * (nd - 2) + ["model", "fsdp"]
    return [None] * (nd - 2) + ["fsdp", "model"]


def _tree_specs(mesh, tree, logical_map, axes_fn):
    with PS.mesh_rules(mesh, logical_map):
        def one(path, leaf):
            spec = PS.pspec_for(_shape(leaf), axes_fn(path, leaf))
            return spec if spec is not None else ()
        return tree_map_with_path(one, tree)


def params_pspecs(mesh, params, logical_map=None):
    """The spec of every leaf of a params tree (tensors or shapes)."""
    return _tree_specs(mesh, params, logical_map, param_logical_axes)


def cache_logical_axes(cfg: ModelConfig, path, leaf) -> list:
    """The logical axes of one contiguous-cache leaf."""
    names = _path_names(path)
    last = names[-1]
    nd = _ndim(leaf)
    model_divides_kv = cfg.n_kv_heads and cfg.n_kv_heads % 16 == 0
    if last in ("k", "v", "xk", "xv"):
        if model_divides_kv:
            return [None, "batch", None, "model", None]
        return [None, "batch", "seq", None, None]
    if last in ("ckv", "krope"):
        return [None, "batch", None, "model"]
    if last == "ssm":
        return [None] * (nd - 4) + ["batch", "model", None, None]
    if last == "conv":
        return [None] * (nd - 3) + ["batch", None, "model"]
    if last == "C":
        return [None] * (nd - 4) + ["batch", None, "model", None]
    if last in ("n",):
        return [None] * (nd - 3) + ["batch", None, "model"]
    if last in ("m", "h"):
        return [None] * (nd - 2) + ["batch", None]
    if last == "c":
        return [None] * (nd - 3) + ["batch", None, None]
    if last == "conv_win":
        return [None] * (nd - 3) + ["batch", None, None]
    return [None] * nd


def cache_pspecs(mesh, cfg: ModelConfig, cache, logical_map=None):
    return _tree_specs(mesh, cache, logical_map,
                       lambda p, l: cache_logical_axes(cfg, p, l))


def cache_seq_axes(cfg: ModelConfig):
    """The mesh axes (a spec entry) over which the installed rules cut a
    contiguous k/v cache's positions, or None: ``cache_logical_axes``
    puts "seq" there where the KV heads do not divide 16, and the port
    cuts the positions over every mesh axis "seq" maps to
    (``shard_cache`` refuses a cache whose positions do not divide)."""
    mesh = PS.current_mesh()
    if mesh is None or not cfg.n_kv_heads or cfg.n_kv_heads % 16 == 0:
        return None
    n = mesh.size               # divides by every part of the mesh
    spec = PS.pspec_for((1, n, n, cfg.n_kv_heads, 1), cache_logical_axes(
        cfg, ("k",), (1, n, n, cfg.n_kv_heads, 1)))
    return spec[2] if PS.entry_size(spec[2]) > 1 else None


def paged_cache_logical_axes(cfg: ModelConfig, path, leaf) -> list:
    """The logical axes of one PAGED pool leaf: k/v pools (L, n_pages,
    page_size, Hkv, hd) on their KV heads, MLA latent pools (L, n_pages,
    page_size, rank) on the latent rank; the layer, page and offset axes
    never."""
    last = _path_names(path)[-1]
    nd = _ndim(leaf)
    if last in ("k", "v"):
        return [None, None, None, "model", None]
    if last in ("ckv", "krope"):
        return [None, None, None, "model"]
    return [None] * nd


def paged_cache_pspecs(mesh, cfg: ModelConfig, cache, logical_map=None):
    return _tree_specs(mesh, cache, logical_map,
                       lambda p, l: paged_cache_logical_axes(cfg, p, l))


def batch_pspecs(mesh, batch, logical_map=None):
    """Every batch input sharded over the "batch" logical axes on dim 0."""
    with PS.mesh_rules(mesh, logical_map):
        def one(leaf):
            shape = _shape(leaf)
            spec = PS.pspec_for(shape, ["batch"] + [None] * (len(shape) - 1))
            return spec if spec is not None else ()
        return tree_map(one, batch)


# ==========================================================================
# the port's placement: each rank's slices
# ==========================================================================

def dense_ff(cfg: ModelConfig) -> int:
    """The width of every dense MLP of a config: a moe config's leading
    dense layers and MTP block take ``dense_d_ff`` (or ``d_ff``)."""
    if cfg.moe is not None:
        return cfg.moe.dense_d_ff or cfg.d_ff
    return cfg.d_ff


def shared_ff(cfg: ModelConfig) -> int:
    m = cfg.moe
    return m.n_shared_experts * m.d_shared_expert


class PackedCut(tuple):
    """The (dim, n, whole size) of a cut whose dim packs several parts,
    ``parts`` = ((size, cut), ...) in order: each cut part holds the
    rank's n-th of it, the others are whole on every rank (a Mamba2
    ``in_proj``'s columns, its conv's channels)."""

    def __new__(cls, dim: int, n: int, whole: int, parts: tuple):
        self = super().__new__(cls, (dim, n, whole))
        self.parts = parts
        return self

    def local(self) -> int:
        """The dim's size on a rank."""
        return sum(s // self[1] if c else s for s, c in self.parts)


MAMBA_STACKS = ("mamba_units", "mamba_tail")


def mamba_parts(cfg: ModelConfig, what: str) -> tuple:
    """((size, cut by heads), ...) of a Mamba2 leaf's packed dim:
    ``in_proj``'s columns z | x | B | C | dt, or (``conv``) the conv's
    channels x | B | C.  z, x and dt follow the heads; B and C stay
    whole, since every head reads them (``n_groups`` 1)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    gn = s.n_groups * s.d_state
    if what == "in_proj":
        return ((d_inner, True), (d_inner, True), (gn, False), (gn, False),
                (d_inner // s.head_dim, True))
    return ((d_inner, True), (gn, False), (gn, False))


def _mamba_heads(cfg: ModelConfig) -> int:
    s = cfg.ssm
    if s.n_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: a Mamba2 block of {s.n_groups} groups on a mesh "
            "(the port cuts whole heads of one group)")
    return s.expand * cfg.d_model // s.head_dim


XLSTM_STACKS = ("mlstm_units", "slstm_units")


def xlstm_dims(cfg: ModelConfig) -> tuple:
    """(d_inner, mLSTM head dim, sLSTM head dim, sLSTM d_ff) of an xLSTM
    config: the twins of ``models.xlstm``'s."""
    d, nh = cfg.d_model, cfg.n_heads
    d_inner = int(cfg.xlstm.proj_factor_mlstm * d)
    return d_inner, d_inner // nh, d // nh, int(cfg.xlstm.proj_factor_slstm
                                                * d)


def xlstm_parts(cfg: ModelConfig, what: str) -> tuple:
    """((size, cut by heads), ...) of an xLSTM leaf's packed columns:
    mLSTM's ``w_up`` main | z, or (``w_gates``) sLSTM's z | i | f | o;
    every part follows the heads."""
    if what == "w_up":
        return ((xlstm_dims(cfg)[0], True),) * 2
    return ((cfg.d_model, True),) * 4


def _xlstm_rule(cfg: ModelConfig, names: list):
    """``_param_rule`` of an xLSTM leaf: whole heads (module
    docstring)."""
    last, nh = names[-1], cfg.n_heads
    d_inner, _, _, f = xlstm_dims(cfg)
    if names[0] == "mlstm_units":
        if last == "w_up":
            return "model", nh, -1, 2 * d_inner, xlstm_parts(cfg, "w_up")
        if last in ("w_q", "w_k", "w_v"):
            return "model", nh, -3, nh
        if last in ("w_if", "w_down"):
            return "model", nh, -2, d_inner
        return None
    if last == "w_gates":
        return "model", nh, -1, 4 * cfg.d_model, xlstm_parts(cfg, "w_gates")
    if "up" in names:
        return {"w_gate": ("model", f, -1, f), "w_up": ("model", f, -1, f),
                "w_down": ("model", f, -2, f)}.get(last)
    return None


def _param_rule(cfg: ModelConfig, names: list):
    """(logical axis, units it divides, dim, whole size of the dim[,
    packed parts]) of the cut of one param leaf, or None
    (replicated)."""
    last = names[-1]
    if names[0] in XLSTM_STACKS:
        return _xlstm_rule(cfg, names)
    if names[0] in MAMBA_STACKS:
        if last not in ("in_proj", "out_proj"):
            return None      # read as the rank's heads' share, replicated
        nh = _mamba_heads(cfg)
        if last == "out_proj":
            return "model", nh, -2, cfg.ssm.expand * cfg.d_model
        parts = mamba_parts(cfg, "in_proj")
        return "model", nh, -1, sum(p[0] for p in parts), parts
    if last == "embed":
        return "model", cfg.vocab_size, 0, cfg.vocab_size
    if last == "lm_head":
        return "model", cfg.vocab_size, -1, cfg.vocab_size
    if "moe" in names:
        if "shared" in names:
            f = shared_ff(cfg)
            return {"w_gate": ("model", f, -1, f), "w_up": ("model", f, -1, f),
                    "w_down": ("model", f, -2, f)}.get(last)
        E = cfg.moe.n_experts
        if last in ("w_gate", "w_up", "w_down"):
            return "expert", E, -3, E
        return None
    if "attn" in names or "xattn" in names:
        if cfg.mla is not None and "attn" in names:
            r = cfg.mla.kv_lora_rank
            return ("model", r, -2, r) if last in ("w_uk", "w_uv") else None
        hd, Hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        whole = {"w_q": cfg.n_heads * hd, "b_q": cfg.n_heads * hd,
                 "w_k": Hkv * hd, "b_k": Hkv * hd, "w_v": Hkv * hd,
                 "b_v": Hkv * hd}
        if last in whole:
            return "model", Hkv, -1, whole[last]
        if last == "w_o":
            return "model", Hkv, -2, cfg.n_heads * hd
        return None
    if "mlp" in names:
        f = dense_ff(cfg)
        return {"w_gate": ("model", f, -1, f), "w_up": ("model", f, -1, f),
                "b_up": ("model", f, -1, f),
                "w_down": ("model", f, -2, f)}.get(last)
    return None


def param_axes(cfg: ModelConfig, path):
    """The mesh axes (a spec entry) of the cut of the param leaf at
    ``path`` under the installed rules, or None when it replicates."""
    rule = _param_rule(cfg, _path_names(path))
    mesh = PS.current_mesh()
    if rule is None or mesh is None:
        return None
    entry = PS._resolve(rule[0], rule[1], mesh)
    return entry if PS.entry_size(entry) > 1 else None


def param_cut(cfg: ModelConfig, path) -> Optional[tuple]:
    """(dim, n, whole size) of the tensor-parallel cut of the param leaf
    at ``path`` under the installed rules (over ``param_axes``), or None
    when it replicates."""
    axes = param_axes(cfg, path)
    if axes is None:
        return None
    rule = _param_rule(cfg, _path_names(path))
    n = PS.entry_size(axes)
    if len(rule) > 4:
        return PackedCut(rule[2], n, rule[3], rule[4])
    return rule[2], n, rule[3]


def grad_axes(cfg: ModelConfig, path) -> tuple:
    """The mesh axes over which a training step sums the gradient of the
    param leaf at ``path`` under the installed rules: the batch cut's
    (``pspec.batch_axes``), but those the leaf itself is cut over.  Only
    the experts are cut over a batch axis (``ep``, ``dp``): their owners
    receive every token of that axis through the MoE's exchange
    (``models.moe``), so their gradient is whole there already."""
    own = _axes_of(param_axes(cfg, path))
    return tuple(a for a in PS.batch_axes() if a not in own)


class FsdpCut(tuple):
    """The (dim, n, whole size) of an FSDP cut, and ``axes``: the mesh
    axes (a spec entry) it is cut over, the "fsdp" entry's that divide
    the dim (("pod", "data") on a mesh with a "pod" axis)."""

    def __new__(cls, dim: int, n: int, whole: int, axes):
        self = super().__new__(cls, (dim, n, whole))
        self.axes = axes
        return self


def fsdp_cut(cfg: ModelConfig, path, shape) -> Optional[FsdpCut]:
    """The FSDP cut (``FsdpCut``: dim, n, whole size and the mesh axes)
    over the "fsdp" entry of the param leaf at ``path`` of whole
    ``shape`` under the installed rules, or None.  The dim is the
    reference's "fsdp" dim (``param_logical_axes``: the non-TP dim of a
    matmul weight), or the matrix's other dim where the port's "model"
    cut took that one (MLA's latent rows, mLSTM's ``w_if`` rows); any
    divisor will do there, since the model gathers the weight before it
    reads it."""
    shape = tuple(shape)
    axes = param_logical_axes(path, shape)
    if "fsdp" not in axes:
        return None
    nd = len(shape)
    dim = axes.index("fsdp") - nd
    mcut = param_cut(cfg, path)
    if mcut is not None and mcut[0] % nd == dim % nd:
        dim = -1 if dim % nd == nd - 2 else -2
    entry = PS._resolve("fsdp", shape[dim], PS.current_mesh())
    if set(_axes_of(entry)) & set(_axes_of(param_axes(cfg, path))):
        # a mesh axis cuts one dim at most (the reference's duplicate
        # guard): under ``ep`` the experts, their dim first, take "data"
        return None
    n = PS.entry_size(entry)
    if n == 1:
        return None
    return FsdpCut(dim, n, shape[dim], entry)


def param_plan(cfg: ModelConfig, shapes, mesh, logical_map=None) -> dict:
    """{path: ("model" cut, FSDP cut)} of every leaf of a params tree of
    whole ``shapes`` (tensors or shape tuples) on ``mesh`` under
    ``logical_map`` (default: the serving map)."""
    with PS.mesh_rules(mesh, _map(logical_map)):
        return {path: (param_cut(cfg, path), fsdp_cut(cfg, path, _shape(t)))
                for path, t in tree_leaves_with_path(shapes)}


def _map(logical_map):
    return SERVING_LOGICAL_MAP if logical_map is None else logical_map


# the families the port trains and runs prefill and decode steps of on a
# mesh, under every preset
MESH_TRAIN_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


def _axes_of(entry) -> tuple:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _batch_fits(got, want) -> bool:
    """A map's "batch" axes ``got`` are the preset's ``want``, or a
    leading part of those, with or without "pod" (a (data, model) mesh
    has none): what ``dryrun._batch_map`` leaves where the rows do not
    divide (the reference's rule drops trailing axes).  Any other batch
    cut is not the preset's."""
    got, want = _axes_of(got), _axes_of(want)
    on = tuple(a for a in want if a != "pod")
    return got in (want[:len(got)], on[:len(got)])


def _check(cfg: ModelConfig, logical_map, what: str) -> dict:
    """The logical map (None: ``baseline``'s; a preset's, its "batch"
    axes perhaps trimmed to those its rows divide) of one of the
    reference's presets, or NotImplementedError where the port does not
    run ``what`` on a mesh: another map, or a family not among
    MESH_TRAIN_FAMILIES."""
    presets = tuple(SHARDING_PRESETS)
    lmap = train_map("baseline") if logical_map is None \
        else dict(logical_map)

    def rest(m):
        return {k: v for k, v in m.items() if k != "batch"}
    preset = next((p for p in presets
                   if rest(train_map(p)) == rest(lmap)
                   and _batch_fits(lmap.get("batch"),
                                   train_map(p).get("batch"))), None)
    if preset is None:
        raise NotImplementedError(
            f"{what} on a mesh takes the reference's presets {presets} "
            f"only, not the logical map {lmap}")
    if cfg.family not in MESH_TRAIN_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no {what} on a mesh for the {cfg.family} family "
            f"(the port's mesh families: {MESH_TRAIN_FAMILIES})")
    return lmap


def check_train(cfg: ModelConfig, logical_map=None) -> dict:
    """The logical map a training mesh runs under (``_check`` over
    every preset)."""
    return _check(cfg, logical_map, "training")


def check_serve(cfg: ModelConfig, logical_map=None) -> dict:
    """The logical map a prefill or decode step runs under on a mesh
    (``_check`` over every preset)."""
    return _check(cfg, logical_map, "prefill or decode step")


def train_map(preset: str) -> dict:
    """The logical map of a training preset (``baseline``: the default
    map)."""
    return SHARDING_PRESETS[preset] or dict(PS.DEFAULT_LOGICAL_MAP)


def pool_cut(cfg: ModelConfig, path, shape) -> Optional[tuple]:
    """(dim, n, whole size) of the cut of the paged-pool leaf at ``path``
    of whole shape ``shape``, by ``paged_cache_logical_axes`` under the
    installed rules, or None when it replicates."""
    spec = PS.pspec_for(shape, paged_cache_logical_axes(cfg, path, shape))
    cuts = [(d, PS.entry_size(e), shape[d])
            for d, e in enumerate(spec or ()) if PS.entry_size(e) > 1]
    assert len(cuts) <= 1, (path, spec)
    return cuts[0] if cuts else None


def local_shape(shape, *cuts) -> tuple:
    """A leaf's shape on one rank, after each of ``cuts`` (None: none)."""
    out = list(shape)
    for cut in cuts:
        if isinstance(cut, PackedCut):
            out[cut[0]] = cut.local()
        elif cut is not None:
            dim, n, _ = cut
            out[dim] //= n
    return tuple(out)


def packed_slice(t, dim: int, parts: tuple, n: int, i: int):
    """Part by part along ``dim`` of ``t`` (whole): the i-th of n of
    each cut part, each other part whole (a view where one piece is
    left, else a new tensor)."""
    pieces, off = [], 0
    for size, cut in parts:
        k = size // n if cut else size
        pieces.append(t.narrow(dim, off + (i * k if cut else 0), k))
        off += size
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)


def _packed_gather(t, cut: PackedCut, mesh, axis):
    """The whole packed dim from each rank's ``t`` (every rank calls
    this): each cut part gathered exactly over ``axis``."""
    dim, n = cut[0], cut[1]
    sizes = [s // n if c else s for s, c in cut.parts]
    pieces = [mesh.gather(p.contiguous(), dim, axis) if c else p
              for p, (_, c) in zip(torch.split(t, sizes, dim), cut.parts)]
    return torch.cat(pieces, dim)


def _ranks(mesh, axis) -> int:
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= mesh.shape[a]
    return n


def take(t, cut, mesh, axis):
    """This rank's slice of ``t`` along the mesh axes ``axis`` (a spec
    entry; a new tensor), ``t`` itself when it replicates or already is
    that slice (its size along the cut is the whole's n-th part: an
    engine's ``clone_fresh``)."""
    if cut is None:
        return t
    dim, n, whole = cut
    if n != _ranks(mesh, axis):
        raise ValueError(f"a cut in {n} on mesh axes {axis!r} of "
                         f"{_ranks(mesh, axis)} ranks")
    k = cut.local() if isinstance(cut, PackedCut) else whole // n
    if t.shape[dim] == k and k != whole:
        return t
    if t.shape[dim] != whole:
        raise ValueError(f"leaf of shape {tuple(t.shape)}: dim {dim} is "
                         f"neither {whole} nor its {n}-th part")
    if isinstance(cut, PackedCut):
        return packed_slice(t, dim, cut.parts, n, mesh.index(axis)).clone()
    return t.narrow(dim, mesh.index(axis) * k, k).clone()


def shard_params(cfg: ModelConfig, params: dict, mesh,
                 logical_map=None) -> dict:
    """Rank ``mesh.rank``'s slices of a params tree (see the module
    docstring; ``logical_map`` defaults to the serving map): cut leaves
    are new tensors, replicated leaves the caller's own, so freeing the
    whole tree frees all but this rank's share.  Under a training
    preset each leaf is cut over "model" and then, on another dim, over
    the "fsdp" entry's axes ("data", or ("pod", "data") on a mesh with a
    "pod" axis: ``fsdp_cut``); the AdamW moments of the slices take the
    same cut."""
    with PS.mesh_rules(mesh, _map(logical_map)):
        def one(path, t):
            mcut = param_cut(cfg, path)
            fcut = fsdp_cut(cfg, path, t.shape) if t.dim() else None
            return take(take(t, mcut, mesh, param_axes(cfg, path)), fcut,
                        mesh, fcut and fcut.axes)
        return tree_map_with_path(one, params)


def unshard_leaf(t, cuts: tuple, mesh, axis):
    """The whole leaf, on every rank, from each rank's slice ``t`` cut by
    ``cuts`` (its ``param_plan`` entry): the exact gathers over the FSDP
    cut's axes then over the tensor-parallel cut's axes ``axis``
    (``param_axes``; every rank must call this)."""
    mcut, fcut = cuts
    if fcut is not None:
        t = mesh.gather(t, fcut[0], fcut.axes)
    if isinstance(mcut, PackedCut):
        return _packed_gather(t, mcut, mesh, axis)
    if mcut is not None:
        t = mesh.gather(t, mcut[0], axis)
    return t


def unshard_params(cfg: ModelConfig, params: dict, mesh,
                   logical_map=None) -> dict:
    """The whole params (or moments) tree, on every rank, from each
    rank's slices (``unshard_leaf``; every rank must call this).  For
    checkpoints and tests."""
    from repro_torch.models import transformer as T
    plan = param_plan(cfg, T.param_shapes(cfg), mesh, logical_map)
    with PS.mesh_rules(mesh, _map(logical_map)):
        axes = {path: param_axes(cfg, path) for path in plan}
    return tree_map_with_path(lambda path, t: unshard_leaf(
        t, plan[path], mesh, axes[path]), params)


def _cache_spec(cfg: ModelConfig, path, shape) -> tuple:
    """A contiguous-cache leaf's spec under the installed rules
    (``cache_logical_axes``), checked to cut the positions over every
    "seq" axis where the rule cuts them (``cache_seq_axes``; whisper's
    cross cache reads its own cut from its shape)."""
    spec = PS.pspec_for(shape, cache_logical_axes(cfg, path, shape)) \
        or (None,) * len(shape)
    cut = spec[2] if PS.entry_size(spec[2]) > 1 else None
    if _path_names(path)[-1] in ("k", "v") and cut != cache_seq_axes(cfg):
        raise NotImplementedError(
            f"a cache of {shape[2]} positions does not cut over the "
            f"'seq' axes {cache_seq_axes(cfg)!r}: the port cuts the "
            "positions evenly or not at all")
    return spec


def _cache_cuts(cfg: ModelConfig, path, shape) -> list:
    """[(dim, mesh axes, packed parts or None)] of each cut dim of a
    contiguous-cache leaf of whole ``shape`` under the installed rules:
    the rule's (``_cache_spec``), but a Mamba2 ``conv`` window's
    channels, cut as the block's weights are (the x channels by the
    rank's heads, B and C whole: ``mamba_parts``)."""
    names = _path_names(path)
    if names[0] in XLSTM_STACKS:
        return _xlstm_cache_cuts(cfg, names, shape)
    spec = list(_cache_spec(cfg, path, shape))
    parts = None
    if names[0] in MAMBA_STACKS and names[-1] == "conv":
        heads = PS._resolve("model", _mamba_heads(cfg), PS.current_mesh())
        taken = {a for e in spec[:-1] for a in _axes_of(e)}
        spec[-1] = (heads if PS.entry_size(heads) > 1
                    and not taken & set(_axes_of(heads)) else None)
        parts = mamba_parts(cfg, "conv")
    return [(d, e, parts if d == len(spec) - 1 else None)
            for d, e in enumerate(spec) if PS.entry_size(e) > 1]


def _xlstm_cache_cuts(cfg: ModelConfig, names: list, shape) -> list:
    """``_cache_cuts`` of an xLSTM state leaf: its rows over the "batch"
    axes on its row dim (the units' axes come first) and, but sLSTM's
    ``conv_win``, its heads (``C``, ``n``, ``m``, ``c``) or its heads'
    channels (mLSTM's ``conv``, sLSTM's ``h``) over the axes the block's
    weights cut the heads over, where those are not the rows'."""
    row = 2 if names[0] == "mlstm_units" else 1
    mesh = PS.current_mesh()
    rows = PS._resolve("batch", shape[row], mesh)
    cuts = [(row, rows, None)] if PS.entry_size(rows) > 1 else []
    last = names[-1]
    if last != "conv_win":
        heads = PS._resolve("model", cfg.n_heads, mesh)
        dim = len(shape) - 1 if last in ("conv", "h") else row + 1
        if PS.entry_size(heads) > 1 and not (set(_axes_of(heads))
                                             & set(_axes_of(rows))):
            cuts.append((dim, heads, None))
    return cuts


def shard_cache(cfg: ModelConfig, cache: dict, mesh,
                logical_map=None) -> dict:
    """Rank ``mesh.rank``'s slices of a whole contiguous cache
    (``transformer.init_cache``'s tree) by the reference's
    ``cache_logical_axes`` under ``logical_map`` (default: the
    reference's, ``baseline``), the Mamba2 conv window's channels and
    the xLSTM state as ``_cache_cuts`` has them: new tensors where cut,
    the caller's own leaves where replicated."""
    lmap = train_map("baseline") if logical_map is None else logical_map
    with PS.mesh_rules(mesh, lmap):
        def one(path, t):
            for d, e, parts in _cache_cuts(cfg, path, tuple(t.shape)):
                n = PS.entry_size(e)
                if parts is not None:
                    t = packed_slice(t, d, parts, n, mesh.index(e)).clone()
                    continue
                k = t.shape[d] // n
                t = t.narrow(d, mesh.index(e) * k, k).clone()
            return t
        return tree_map_with_path(one, cache)


def _positions(t: torch.Tensor, S_cache: int, ring: bool) -> torch.Tensor:
    """A leaf's positions (dim 2) as a cache of ``S_cache`` slots: the
    prompt's S positions at slots 0..S-1 and zeros after, or in a ring
    (``ring``, S > S_cache) its last S_cache positions at slot ``pos %
    S_cache``."""
    S = t.shape[2]
    if S <= S_cache:
        if S == S_cache:
            return t
        pad = t.new_zeros((*t.shape[:2], S_cache - S, *t.shape[3:]))
        return torch.cat([t, pad], dim=2)
    if not ring:
        raise ValueError(f"a prompt of {S} positions in a cache of "
                         f"{S_cache}")
    return torch.roll(t[:, :, S - S_cache:], (S - S_cache) % S_cache, 2)


def rank_cache(cfg: ModelConfig, cache: dict, max_seq=None) -> dict:
    """A prefill's cache (``transformer.prefill``'s: k/v (L, B, S, h,
    hd) of the rank's rows and of the heads its weights compute,
    ckv/krope (L, B, S, width) whole, whisper's cross xk/xv (L, B, F, h,
    hd) likewise) as the rank's slice of a cache of ``max_seq``
    positions (default S; a ring of ``min(max_seq, window)`` slots under
    a sliding window; the cross cache keeps its F frames), by the
    installed rules (``cache_logical_axes``), the prompt's positions at
    their slots.  Where the rule keeps every KV head on the rank and its
    weights compute fewer, the heads are gathered (one exact gather a
    leaf, every rank calls this).  Recurrent state (the Mamba2 ``ssm``
    and ``conv``) is the rank's already: its rows, and its heads as its
    weights compute them.  Without a mesh only the positions are
    placed."""
    from repro_torch.models import layers as L
    mesh = PS.current_mesh()
    win = cfg.sliding_window

    def one(path, t):
        last = _path_names(path)[-1]
        if last not in ("k", "v", "xk", "xv", "ckv", "krope"):
            return t
        cross = last in ("xk", "xv")
        S_cache = t.shape[2] if max_seq is None or cross else (
            min(max_seq, win) if win else max_seq)
        heads = (cfg.n_kv_heads if last in ("k", "v", "xk", "xv")
                 else t.shape[3])
        whole = (*t.shape[:2], S_cache, heads, *t.shape[4:])
        if mesh is not None:
            spec = _cache_spec(cfg, path, whole)
            if t.shape[3] != heads and spec[3] is None:   # every head here
                m, ax = L.tp_axis(t.shape[3], heads)
                t = m.gather(t, 3, ax)
        t = _positions(t, S_cache, bool(win) and not cross)
        if mesh is None:
            return t
        for d in (2, 3):       # the positions, the heads or latent width
            n = PS.entry_size(spec[d])
            if n > 1 and t.shape[d] == whole[d]:
                k = whole[d] // n
                t = t.narrow(d, mesh.index(spec[d]) * k, k)
        return t.contiguous()
    return tree_map_with_path(one, cache)


def shard_batch(batch: dict, mesh, logical_map=None) -> dict:
    """This rank's rows of every leaf of a global batch (numpy arrays or
    tensors, rows on dim 0) under ``logical_map`` (default: the
    reference's, "batch" over ("pod", "data")).  The rows must divide
    the cut."""
    with PS.mesh_rules(mesh, logical_map):
        i, n = PS.batch_rank()

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not cut "
                             f"into {n} equal blocks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]
    return tree_map(rows, batch)
