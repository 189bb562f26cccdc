"""Mixture-of-Experts MLP: the twin of the JAX package's ``models/moe.py``
on the serving paths.

Two dispatch strategies, as in the reference:

* ``einsum`` — GShard-style grouped one-hot dispatch/combine products
  (the reference's serving default, and so the port's).
* ``scatter`` — capacity-bounded scatter/gather dispatch: each routing
  is placed in its (expert, slot) row of a buffer by ``index_add_``
  (dropped routings land on a trash row past the last slot), and the
  combine gathers the rows back.

Routing takes the top ``k`` experts by a STABLE descending sort of the
router probabilities, so a tie goes to the lower expert index, as
``jax.lax.top_k`` orders it (``torch.topk`` promises no order on
ties).  Slots are assigned by a cumulative count in (group, token, k)
order, so the same routings overflow the same capacity as in the
reference and the overflow counts agree exactly.

The expert FFN stays ``torch.einsum`` over the stacked expert weights:
the reference computes it outside any Pallas kernel.

Expert parallel under a serving mesh (``launch.sharding``): the stacked
expert weights hold this rank's ``E / n`` experts (a contiguous run).
Routing, slot positions and the overflow count are computed on every
rank from the same replicated activations, so capacity and the
engines' retry loop agree on every rank and with the reference; each
rank dispatches only to its own experts, and one all-reduce sums their
outputs (the shared expert is row-parallel, with its own).

Where the experts are cut over an axis that also cuts the tokens (the
reference's ``ep``: experts over both axes, tokens over "data"; ``dp``:
experts over "model", tokens over both), the reference leaves GSPMD to
move the dispatched tensor; the port exchanges it itself
(``_owners``).  Each rank routes and places its own tokens exactly as
on one rank, dispatches them to the experts of every rank along those
axes, and sends each owner the fixed-capacity (n, E_loc, C, d) block of
its experts (``Mesh.all_to_all``, an even split); the owner runs its
experts on every block it received and sends the results back, and the
token's rank combines them.  Backward, the exchange runs in reverse:
each token's gradient returns to its rank, and an expert's weight
gradient covers every token sent to it, so it is not summed over those
axes again (``launch.sharding.grad_axes``).  Along the experts' other
axes (``ep``'s "model") the ranks hold the same tokens and other
experts: their outputs are summed, and the tokens' gradient with them.

On a training mesh (``launch.steps.make_train_step(mesh=...)``) each
rank routes its own rows of the batch, and the routing is still the
reference's over the WHOLE batch, token for token:

  * the groups come from the global token count, and where a group
    spans ranks of the batch cut, a rank's slot positions start after
    the per-expert counts of the lower ranks in its group (one
    all-reduce of a (ranks, E) buffer), with the capacity of the global
    group, so the same routings are dropped;
  * the load-balance loss ``E * sum_e f_e * P_e`` takes f and P over
    every token: their per-expert sums are summed over the batch cut
    before the product.

``drop_counts`` records the dropped routings of each MoE layer of a
training forward.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import pspec as PS

F32 = torch.float32
CAPACITY_FACTOR = 1.25
_DROPS = [None]


@contextmanager
def drop_counts():
    """Record the routings each capacity-bounded (training) MoE layer
    drops: yields a dict that maps each layer (its router's storage) to
    the count of this rank's dropped routings, a 0-d tensor.  A layer
    recomputed under remat records the same count again, not twice."""
    prev = _DROPS[0]
    _DROPS[0] = {}
    try:
        yield _DROPS[0]
    finally:
        _DROPS[0] = prev


def _ceil4(x: int) -> int:
    """Expert capacities round up to a multiple of 4 (min 4)."""
    return max(4, -(-int(x) // 4) * 4)


def init_moe(cfg: ModelConfig, gen, device, lead=()) -> dict:
    """MoE params with leading stack axes ``lead``, drawn in the
    reference's order (router, gate, up, down, shared).  The router is
    fp32 whatever ``param_dtype`` is.  The stacked expert leaves
    (E, d, f) take fan-in E, as the reference's ``dense_init`` (fan-in
    ``shape[0]``) gives them; every matrix is drawn on its own, so an
    uncut qwen3-moe stack never holds an fp32 copy of a whole leaf."""
    m = cfg.moe
    dt = L.dtype_of(cfg.param_dtype)
    d, E = cfg.d_model, m.n_experts
    p = {"router": L.dense_init((*lead, d, E), F32, gen, device),
         "w_gate": L.dense_init((*lead, E, d, m.d_expert), dt, gen, device,
                                fan_in=E),
         "w_up": L.dense_init((*lead, E, d, m.d_expert), dt, gen, device,
                              fan_in=E),
         "w_down": L.dense_init((*lead, E, m.d_expert, d), dt, gen, device,
                                fan_in=E)}
    if m.n_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, m.n_shared_experts
                                    * m.d_shared_expert, dt, device, lead)
    return p


def _route(p, cfg, x2d):
    """x2d: (T, d) -> (probs (T,k), experts (T,k), aux_loss, full_probs).
    Top-k by a stable descending sort: ties keep the lower index first,
    as ``jax.lax.top_k`` does."""
    m = cfg.moe
    logits = x2d.to(F32) @ p["router"]                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = order.values[:, :m.experts_per_token]
    top_e = order.indices[:, :m.experts_per_token]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)          # renormalize
    # GShard/Switch load-balance loss: E * sum_e f_e * P_e
    assign = F.one_hot(top_e, m.n_experts).to(F32).sum(1)    # (T, E)
    _, n_b = PS.batch_rank()
    if n_b == 1:
        f = assign.mean(0) / m.experts_per_token
        P = probs.mean(0)
    else:                      # means over the whole batch's tokens
        sums = L.batch_sum(torch.cat([assign.sum(0), probs.sum(0)]))
        n_tok = x2d.shape[0] * n_b
        f = sums[:m.n_experts] / n_tok / m.experts_per_token
        P = sums[m.n_experts:] / n_tok
    aux = m.n_experts * torch.sum(f * P) * m.router_aux_loss
    return top_p, top_e, aux, probs


def _capacity(cfg, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(tokens_per_group * m.experts_per_token * CAPACITY_FACTOR
            / m.n_experts)
    return _ceil4(c)


def initial_capacity(cfg: ModelConfig, n_tokens: int,
                     factor: float = 2.0) -> int:
    """First guess for the dynamic drop-free serving-prefill capacity:
    ``factor`` x the mean per-expert load (``T*k/E``), rounded up to a
    multiple of 4; the engines double it on overflow."""
    m = cfg.moe
    mean = n_tokens * m.experts_per_token / m.n_experts
    return min(_ceil4(mean * factor), n_tokens)


def _expert_ffn(p, xe):
    """xe: (..., E, C, d) -> gated FFN per expert (weights stacked on E)."""
    h = torch.einsum("...ecd,edf->...ecf", xe, p["w_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xe, p["w_up"])
    h = F.silu(h.to(F32)).to(xe.dtype) * u
    return torch.einsum("...ecf,efd->...ecd", h, p["w_down"])


def _groups(T: int, group_size: int) -> int:
    """The reference's grouping of ``T`` tokens (the whole batch's):
    >= 16 groups of ``group_size`` (halved until it divides) at
    T >= 16 * group_size, else one group of T."""
    if T < 16 * group_size:
        return T
    G = group_size
    while G > 1 and (T % G or T // G < 16):
        G //= 2
    return max(G, 1)


def _rank_offsets(eg, n_experts: int, i_b: int, n_b: int, per: int):
    """Where a group spans ``per`` ranks of the batch cut (this rank the
    ``i_b``-th of ``n_b``): for each routing of ``eg`` (1, T, k), the
    count of routings to its expert on the lower ranks of its group."""
    counts = torch.zeros((n_b, n_experts), dtype=torch.int64,
                         device=eg.device)
    counts[i_b] = F.one_hot(eg.reshape(-1), n_experts).sum(0)
    counts = PS.current_mesh().all_reduce(counts, PS.batch_axes())
    lower = counts[(i_b // per) * per:i_b].sum(0)
    return lower[eg]


def moe_fwd(p: dict, cfg: ModelConfig, x, *, dispatch: str = "einsum",
            group_size: int = 2048, drop_free: bool = False,
            capacity=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (y, aux).

    drop_free: size expert capacity so no token is ever dropped (every
    serving path).  capacity: optional bound on the drop-free capacity;
    when set, aux is the number of overflowed routings as fp32 (0 means
    the result is token-exact with the unbounded path; nonzero means
    the caller must re-run with a larger bound).  Otherwise aux is the
    load-balance loss."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    top_p, top_e, aux, _ = _route(p, cfg, x2d)
    i_b, n_b = PS.batch_rank()
    G = _groups(T * n_b, group_size)
    if (T % G if G <= T else G % T):
        raise NotImplementedError(
            f"MoE groups of {G} tokens across ranks of {T} tokens each")
    G_loc = min(G, T)
    n = T // G_loc
    C_exact = _ceil4(G)                 # every token routed to ONE expert
    if drop_free:
        C = C_exact if capacity is None else min(_ceil4(capacity), C_exact)
    else:
        C = _capacity(cfg, G)
    xg = x2d.reshape(n, G_loc, d)
    eg = top_e.reshape(n, G_loc, m.experts_per_token)
    pg = top_p.reshape(n, G_loc, m.experts_per_token)
    pos = _slot_positions(eg, m.n_experts)
    if G > T:                           # the group spans ranks' rows
        pos = pos + _rank_offsets(eg, m.n_experts, i_b, n_b, G // T)
    if drop_free and capacity is not None:
        # overflow channel replaces the balance loss (serving never
        # trains): routings past the capacity bound, the whole batch's
        aux = (pos >= C).sum().to(F32)
        if n_b > 1:
            aux = PS.current_mesh().all_reduce(aux, PS.batch_axes())
    elif not drop_free and _DROPS[0] is not None:
        _DROPS[0][p["router"].data_ptr()] = (pos >= C).sum()
    E_loc = p["w_gate"].shape[-3]
    experts = ex = rep = None
    if E_loc != m.n_experts:
        experts, ex, rep = PS.resolved(
            ("experts", E_loc, m.n_experts, x.device),
            lambda: _owners(E_loc, m.n_experts, x.device))
        if rep is not None:
            xg, pg = L.to_model(xg, rep), L.to_model(pg, rep)
    if dispatch == "einsum":
        y = _dispatch_einsum(p, cfg, xg, eg, pg, pos, C, experts, ex)
    elif dispatch == "scatter":
        y = _dispatch_scatter(p, cfg, xg, eg, pg, pos, C, experts, ex)
    else:
        raise ValueError(dispatch)
    y = y.reshape(B, S, d)
    if rep is not None:
        y = L.sum_over(y, rep)
    if m.n_shared_experts:
        y = y + L.swiglu(p["shared"], x,
                         d_ff=m.n_shared_experts * m.d_shared_expert)
    return y, aux


def _slot_positions(eg, n_experts):
    """Position of each (token, k) routing within its expert's slots.
    eg: (n, G, k) -> (n, G, k) int64 cumulative index per expert."""
    n, G, k = eg.shape
    flat = eg.reshape(n, G * k)
    onehot = F.one_hot(flat, n_experts)                       # (n, G*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1                     # 0-based
    pos = torch.gather(pos, -1, flat[..., None])[..., 0]
    return pos.reshape(n, G, k)


def _entry(axes: tuple):
    """A spec entry of mesh axes: None, one name, or a tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _owners(E_loc: int, n_experts: int, device) -> tuple:
    """Where the experts of a rank holding ``E_loc`` of ``n_experts``
    live under the installed rules: (experts, exchange, replicas).  The
    experts are cut over the mesh axes ``layers.tp_axis`` gives them.
    Of those, the axes that also cut the batch hold other tokens: this
    rank sends its routings to the owners along them and gets theirs
    (``exchange``: the axes, or None where none do).  The others
    hold the same tokens and other experts: their partial outputs are
    summed (``replicas``: the axes, or None).  ``experts``: the experts
    of this rank's exchange group, a block of ``E_loc`` a rank in their
    order along the exchange's axes, the experts this rank routes to: a
    ``slice`` of the ids where they run in one block (always without an
    exchange), else a tensor of their ids; None where they are all.
    ``moe_fwd`` resolves this once a step (``pspec.resolved``)."""
    mesh, entry = L.tp_axis(E_loc, n_experts, "expert")
    names = entry if isinstance(entry, tuple) else (entry,)
    batch = PS.batch_axes()
    xaxes = tuple(a for a in names if a in batch)
    blocks = []
    for j in range(math.prod(mesh.shape[a] for a in xaxes)):
        coord = dict(mesh.coord)
        for a in reversed(xaxes):                # j's place along them
            j, coord[a] = divmod(j, mesh.shape[a])
        b = 0
        for a in names:
            b = b * mesh.shape[a] + coord[a]
        blocks.append(b)
    if blocks == list(range(blocks[0], blocks[0] + len(blocks))):
        experts = slice(blocks[0] * E_loc, (blocks[-1] + 1) * E_loc)
        if experts == slice(0, n_experts):
            experts = None
    else:
        experts = torch.cat([torch.arange(b * E_loc, (b + 1) * E_loc,
                                          device=device) for b in blocks])
    return (experts, _entry(xaxes),
            _entry(tuple(a for a in names if a not in xaxes)))


def _owners_ffn(p, xe, ex):
    """``_expert_ffn`` of the dispatched blocks ``xe`` (n, R, C, d), R
    the experts routed to, run by their owners: without an exchange
    here (the rank holds them all); with the exchange's axes ``ex``
    each owner along them gets the (n, E_loc, C, d) block of its experts
    from every rank there, runs them, and sends each rank its results
    back (``layers.exchange``, twice)."""
    if ex is None:
        return _expert_ffn(p, xe)
    n, R, C, d = xe.shape
    k = p["w_gate"].shape[-3]
    j = R // k
    sent = xe.reshape(n, j, k, C, d).transpose(0, 1)       # (owner, n, ...)
    got = L.exchange(sent, ex)                             # (sender, n, ...)
    he = _expert_ffn(p, got.reshape(j * n, k, C, d))
    back = L.exchange(he.reshape(j, n, k, C, d), ex)       # (owner, n, ...)
    return back.transpose(0, 1).reshape(n, R, C, d)


def _dispatch_einsum(p, cfg, xg, eg, pg, pos, C, experts=None, ex=None):
    """GShard one-hot dispatch.  xg: (n, G, d); pos: (n, G, k) expert
    slot of each routing (from ``_slot_positions``).  A routing past C
    has an all-zero slot one-hot, so it dispatches and combines
    nothing.  Only the ``experts`` (a slice or a tensor of ids, as
    ``_owners`` gives them; None: all) take part, run by their owners
    (``_owners_ffn`` through ``ex``)."""
    m = cfg.moe
    dt = xg.dtype
    keep = pos < C
    e_oh = F.one_hot(eg, m.n_experts)                          # (n,G,k,E)
    if experts is not None:
        e_oh = e_oh[..., experts]
    e_oh = e_oh.to(dt)
    c_oh = F.one_hot(pos.clamp(max=C), C + 1)[..., :C].to(dt)  # (n,G,k,C)
    disp = torch.einsum("ngke,ngkc->ngec", e_oh * keep[..., None].to(dt),
                        c_oh)
    # combine weights in the activation dtype, as the reference
    comb = torch.einsum("ngke,ngkc->ngec",
                        e_oh * (pg * keep).to(dt)[..., None], c_oh)
    xe = torch.einsum("ngec,ngd->necd", disp, xg)              # (n,E,C,d)
    he = _owners_ffn(p, xe, ex)
    return torch.einsum("ngec,necd->ngd", comb, he)


def _dispatch_scatter(p, cfg, xg, eg, pg, pos, C, experts=None, ex=None):
    """Scatter/gather dispatch: no matmul in routing.  Each routing's
    row lands by ``index_add_`` in slot ``e * C + pos`` of a buffer with
    one trash row (index E * C) for the routings past C, and for those
    to experts not among ``experts`` (a slice or a tensor of ids, as
    ``_owners`` gives them; None: all), which run by their owners
    (``_owners_ffn`` through ``ex``)."""
    m = cfg.moe
    n, G, d = xg.shape
    k = m.experts_per_token
    E = m.n_experts
    if isinstance(experts, slice):     # expert id -> its place
        E = experts.stop - experts.start
        eg = eg - experts.start
        eg = torch.where(eg < E, eg, -1)
    elif experts is not None:          # expert id -> its place, or -1
        E = experts.numel()
        rel = torch.full((m.n_experts,), -1, dtype=eg.dtype,
                         device=eg.device)
        rel[experts] = torch.arange(E, dtype=eg.dtype, device=eg.device)
        eg = rel[eg]
    keep = (pos < C) & (eg >= 0)
    slot = eg * C + pos.clamp(0, C - 1)                        # (n, G, k)
    slot = torch.where(keep, slot, E * C)
    xrep = xg[:, :, None, :].expand(n, G, k, d)
    base = (torch.arange(n, device=xg.device) * (E * C + 1))[:, None, None]
    buf = torch.zeros((n * (E * C + 1), d), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, (slot + base).reshape(-1), xrep.reshape(-1, d))
    xe = buf.reshape(n, E * C + 1, d)[:, :-1].reshape(n, E, C, d)
    he = _owners_ffn(p, xe, ex).reshape(n, E * C, d)
    got = torch.gather(he, 1, slot.clamp(max=E * C - 1).reshape(n, G * k, 1)
                       .expand(n, G * k, d)).reshape(n, G, k, d)
    w = torch.where(keep, pg, torch.zeros((), dtype=pg.dtype,
                                          device=pg.device))
    return (got * w[..., None].to(he.dtype)).sum(2)
