"""AdamW + cosine schedule with linear warmup: the twin of the JAX
package's ``training/optim.py``, as plain functions over (nested) dicts
of tensors, in the reference's order of operations.

Not ``torch.optim.AdamW``: the reference clips by the global norm
(``min(1, clip / (gn + 1e-9))``), puts the decay inside the step
(``mhat / (sqrt(vhat) + eps) + wd * p``, on every leaf), runs its
schedule in fp32 and keeps its moments in ``moment_dtype``."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def lr_schedule(cfg: OptimConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, 0.1 + 0.9 * cos)


def adamw_init(params: dict, cfg: OptimConfig) -> dict:
    dt = dtype_of(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    leaf = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def global_norm(tree, mesh=None, replicas=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` (nested dicts, or a list of
    leaves) at once.  On a ``mesh``
    each rank holds slices: ``replicas`` lists, leaf by leaf, how many
    ranks hold the same slice (1 for a leaf cut over every axis, the
    mesh's size for a replicated one), so each leaf's squares are summed
    over the axes it is cut on and a replicated leaf counts once (one
    all-reduce); the norm is then the same on every rank."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                              for x in leaves))
    sq = sum(torch.sum(torch.square(x.to(F32))) / r
             for x, r in zip(leaves, replicas))
    return torch.sqrt(mesh.all_reduce(sq.reshape(1))[0])


# entries of a leaf a donated update computes at once (64 MB in fp32)
DONATED_PIECE = 1 << 24


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, cfg: OptimConfig,
                 grad_norm=None, donate: bool = False):
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).
    Returns new tensors; the inputs are not written, unless ``donate``:
    then each param and moment leaf takes its new value in place, a
    piece of DONATED_PIECE entries at a time (the reference's sharded
    step donates its params and moments, ``donate_argnums=(0, 1)``), so
    the step never holds two copies of them.  ``grad_norm``: the
    gradients' global norm where the caller holds slices of them (a
    mesh: ``global_norm(grads, mesh, replicas)``); the update itself is
    elementwise, so it runs on each rank's slices as they are."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp_max(cfg.grad_clip / (gn + 1e-9), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)
    mdt = dtype_of(cfg.moment_dtype)

    def upd(p, g, mu, nu):
        g = g.to(F32) * clip
        mu_n = b1 * mu.to(F32) + (1 - b1) * g
        nu_n = b2 * nu.to(F32) + (1 - b2) * torch.square(g)
        mhat = mu_n / c1
        vhat = nu_n / c2
        delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * p.to(F32))
        p_n = p.to(F32) - lr * delta
        return p_n.to(p.dtype), mu_n.to(mdt), nu_n.to(mdt)

    def in_place(p, g, mu, nu):
        """``upd`` written into the leaf, DONATED_PIECE entries at a
        time: the same values, a piece's temporaries at most."""
        if not all(t.is_contiguous() for t in (p, mu, nu)):
            for t, new in zip((p, mu, nu), upd(p, g, mu, nu)):
                t.copy_(new)
            return p, mu, nu
        flat = (p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1))
        for i in range(0, p.numel(), DONATED_PIECE):
            piece = [t[i:i + DONATED_PIECE] for t in flat]
            for t, new in zip(piece[:1] + piece[2:], upd(*piece)):
                t.copy_(new)
        return p, mu, nu

    out = tree_map(in_place if donate else upd, params, grads, state["mu"],
                   state["nu"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"grad_norm": gn, "lr": lr})
