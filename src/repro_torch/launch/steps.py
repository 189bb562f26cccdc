"""Step functions of the port: the twin of the JAX package's
``launch/steps.py``.  ``make_train_step`` is what ``training.loop.train``
and ``launch/train.py`` run, on one rank or on a ``(data, model)`` mesh
of ranks (the reference's sharded step: its ``make_train_step`` jitted
with ``in_shardings=(p_spec, o_spec, b_spec)`` under a preset,
``launch/dryrun.py``).  ``make_prefill_step`` and ``make_serve_step``
are the reference's, which its dry-run builds (so does the port's,
``launch.dryrun``); the engines call ``transformer.prefill`` and
``transformer.decode_step`` themselves.  Each step marks its stages
for the dry-run's counter (``analysis.hlo.mark``; nothing without
one)."""
from __future__ import annotations

from contextlib import nullcontext

import torch

from repro_torch.analysis import hlo
from repro_torch.config import ModelConfig
from repro_torch.launch import sharding as SH
from repro_torch.models import pspec as PS
from repro_torch.models import transformer as T
from repro_torch.training import optim
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_unflatten

F32 = torch.float32


def _sum_over(mesh, grads: list, axes: list) -> list:
    """Each gradient of ``grads`` summed over its mesh ``axes`` (() for
    none): one fp32 all-reduce per set of axes, over the gradients that
    share it, each cast back to its type."""
    out = list(grads)
    by_axes: dict = {}
    for i, a in enumerate(axes):
        if a:
            by_axes.setdefault(a, []).append(i)
    for a, idx in by_axes.items():
        flat = mesh.all_reduce(
            torch.cat([grads[i].reshape(-1).to(F32) for i in idx]), a)
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view(grads[i].shape).to(
                grads[i].dtype)
            off += n
    return out


def _norm_parts(plan: dict, paths, grads: list, replicas: dict) -> tuple:
    """(pieces, how many ranks hold each) of the gradients for their
    global norm: a leaf as it is, but a packed one
    (``sharding.PackedCut``) in its parts, a whole part being held by
    the cut's ranks too."""
    pieces, reps = [], []
    for path, g in zip(paths, grads):
        m = plan[path][0]
        if not isinstance(m, SH.PackedCut):
            pieces.append(g)
            reps.append(replicas[path])
            continue
        sizes = [s // m[1] if c else s for s, c in m.parts]
        for piece, (_, c) in zip(torch.split(g, sizes, m[0]), m.parts):
            pieces.append(piece)
            reps.append(replicas[path] * (1 if c else m[1]))
    return pieces, reps


def _reads(cfg: ModelConfig, mesh, lmap) -> tuple:
    """(param plan, {path: the mesh axes its gradient is summed over}
    (``sharding.grad_axes``) of every leaf, {path: (FSDP dim or None,
    those axes, the FSDP cut's mesh axes or None)} of the leaves the
    model reads through ``layers.gathered``: those cut for FSDP, and the
    unembedding weight) of ``cfg`` on ``mesh`` under ``lmap``."""
    plan = SH.param_plan(cfg, T.param_shapes(cfg), mesh, lmap)
    with PS.mesh_rules(mesh, lmap):
        axes = {path: SH.grad_axes(cfg, path) for path in plan}
    unembed = ("embed",) if cfg.tie_embeddings else ("lm_head",)
    reads = {path: (None, axes[path], None) if f is None
             else (f[0], axes[path], f.axes)
             for path, (_, f) in plan.items()
             if f is not None or path == unembed}
    return plan, axes, reads


def _serve_rules(cfg: ModelConfig, mesh, logical_map):
    """The rules a prefill or decode step runs under on ``mesh`` (a
    context factory; None: one rank): ``logical_map`` (None: the
    reference's default, ``baseline``; or any other of its presets,
    ``sharding.check_serve``) with its read plan, so
    FSDP-cut weights are gathered where they are read, and the axes a
    contiguous cache's positions are cut over (``sharding.cache_seq_axes``,
    resolved here once).  The families of ``sharding.MESH_TRAIN_FAMILIES``,
    as in training."""
    if mesh is None:
        return nullcontext
    lmap = SH.check_serve(cfg, logical_map)
    _, _, reads = _reads(cfg, mesh, lmap)
    with PS.mesh_rules(mesh, lmap):
        seq = SH.cache_seq_axes(cfg)
    return lambda: PS.mesh_rules(mesh, lmap, reads, seq)


def make_prefill_step(cfg: ModelConfig, *, mode: str = "flash",
                      moe_dispatch: str = "einsum", mesh=None,
                      logical_map=None, max_seq=None):
    """prefill_step(params, batch) -> (last-position logits, cache): the
    reference's, ``transformer.prefill`` (the MoE drop-free at its
    static capacity).  With a ``mesh``, ``params`` and ``batch`` are
    this rank's slices and rows, as in ``make_train_step``, and the
    cache is the rank's slice by the reference's rule, which
    ``make_serve_step`` takes.  ``max_seq``: the cache's positions
    (default the prompt's; see ``transformer.prefill``)."""
    rules = _serve_rules(cfg, mesh, logical_map)

    def prefill_step(params, batch):
        with rules():
            return T.prefill(params, cfg, batch, mode=mode,
                             moe_dispatch=moe_dispatch, max_seq=max_seq)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None, logical_map=None):
    """serve_step(params, cache, tokens, pos) -> (logits, cache): the
    reference's, one ``transformer.decode_step`` on a contiguous cache
    (written in place).  With a ``mesh``, ``params``, ``cache`` and
    ``tokens`` are this rank's slices (``sharding.shard_cache``, or a
    mesh prefill step's cache), under the same presets as
    ``make_prefill_step``."""
    rules = _serve_rules(cfg, mesh, logical_map)

    def serve_step(params, cache, tokens, pos):
        with rules():
            return T.decode_step(params, cfg, cache, tokens, pos)
    return serve_step


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptimConfig, *,
                    mode: str = "flash", moe_dispatch: str = "einsum",
                    remat: bool = True, mesh=None, logical_map=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``loss_fn``'s gradient (its MoE through ``moe_dispatch``)
    with respect to every param leaf
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives it), then one ``adamw_update``.  On one rank
    the inputs are not written; metrics are ``loss_fn``'s and the
    optimizer's, 0-d tensors.

    With a ``mesh`` (``launch.mesh.make_mesh``; every rank builds the
    step and calls it in lockstep) under ``logical_map`` (one of the
    reference's presets, ``sharding.train_map``; None: ``baseline``),
    ``params`` and ``opt_state`` are this rank's slices
    (``sharding.shard_params`` and ``optim.adamw_init`` of them) and
    ``batch`` its rows (``sharding.shard_batch``).  Each rank runs the
    loss and its backward on its slices, through the mesh's collectives
    (under ``ep`` and ``dp`` the MoE's token exchange with the experts'
    owners); the gradients of each leaf are then summed over the
    batch-cut axes (``sharding.grad_axes``) that its read's backward did
    not already sum, the norm is the global one, and the update is each
    rank's slices of the unsharded step's.  The metrics are the whole
    batch's, the same on every rank.  The mesh's step donates its params
    and moments, as the reference's sharded step does
    (``donate_argnums=(0, 1)``): they take their new values in place and
    are returned, so a rank never holds two copies of them.
    """
    if mesh is None:
        return _step(cfg, opt_cfg, mode, moe_dispatch, remat)
    lmap = SH.check_train(cfg, logical_map)
    plan, axes, reads = _reads(cfg, mesh, lmap)

    def n_of(cut):
        return 1 if cut is None else cut[1]
    # a read leaf's gradient is summed where the model reads it
    axes = {path: () if path in reads else a for path, a in axes.items()}
    replicas = {path: mesh.size // (n_of(m) * n_of(f))
                for path, (m, f) in plan.items()}

    def reduce(paths, grads):
        grads = _sum_over(mesh, grads, [axes[p] for p in paths])
        pieces, reps = _norm_parts(plan, paths, grads, replicas)
        return grads, optim.global_norm(pieces, mesh, reps)
    return _step(cfg, opt_cfg, mode, moe_dispatch, remat,
                 rules=lambda: PS.mesh_rules(mesh, lmap, reads),
                 reduce=reduce, donate=True)


def _step(cfg, opt_cfg, mode, moe_dispatch, remat, rules=None,
          reduce=None, donate=False):
    """The step, with ``rules`` installing the mesh around the loss, its
    backward and the update, and ``reduce(paths, grads)`` giving the
    summed gradients and their norm (None: one rank)."""
    def train_step(params, opt_state, batch):
        with rules() if rules else nullcontext():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            paths, leaves = zip(*tree_leaves_with_path(p))
            with torch.enable_grad():
                total, metrics = T.loss_fn(p, cfg, batch, mode=mode,
                                           moe_dispatch=moe_dispatch,
                                           remat=remat)
                hlo.mark("forward")
                grads = torch.autograd.grad(total, leaves,
                                            allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]
            gn = None
            if reduce is not None:
                grads, gn = reduce(paths, grads)
            hlo.mark("backward")
            del p, leaves, total           # the graph, before a donation
            params, opt_state, om = optim.adamw_update(
                params, tree_unflatten(params, grads), opt_state, opt_cfg,
                grad_norm=gn, donate=donate)
            hlo.mark("update")
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om}
    return train_step
