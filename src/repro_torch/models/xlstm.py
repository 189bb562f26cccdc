"""xLSTM blocks [arXiv:2405.04517]: the twin of the JAX package's
``models/xlstm.py``.  mLSTM (matrix memory, chunkwise parallel) and
sLSTM (scalar memory, sequential).

mLSTM cell per head (dqk = dv = d_inner / n_heads):
    m_t = max(logsig(f~_t) + m_{t-1}, i~_t)
    C_t = e^{logsig(f~)+m_{t-1}-m_t} C_{t-1} + e^{i~-m_t} k_t v_t^T
    n_t = (same decays) n_{t-1} + e^{i~-m_t} k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, e^{-m_t})
computed in the stabilized chunkwise form (quadratic within chunks, a
loop across chunk states, the reference's ``lax.scan``).  sLSTM is
sequential by design: a loop over time steps.  The reference runs no
Pallas kernel in either block, so neither does the port: plain PyTorch,
gate and state math in fp32, projections in the activation dtype.
``b_if`` and ``b_gates`` stay fp32 in any param dtype, as the reference
keeps them.  Decode steps return their new cache entry; the caller
writes it back.

Under a mesh (``launch.sharding``) a block holds the rank's whole
heads.  mLSTM: ``w_up`` its heads' main and z columns, ``w_q``, ``w_k``
and ``w_v`` its heads, ``w_if`` and ``w_down`` its heads' channels'
rows: the gates are the sum of the ranks' partial products (one fp32
all-reduce of the (B, S, 2 nh) pre-activations, under autograd with the
all-reduce for its backward too, since each rank reads its heads'
gates of a sum every channel feeds), and ``w_down`` is row-parallel.
sLSTM: ``w_gates`` its heads' columns of each of z | i | f | o; the
normed input and its conv stay whole; the heads' outputs are gathered
whole (one exact gather a block) for the SwiGLU ``up``, which is cut
on its ``d_ff`` where that divides.  The replicated ``conv_w``,
``conv_b``, ``skip``, ``b_if``, ``r_gates``, ``b_gates`` and the
per-head norm's scale are read as the rank's share (``_m_view``,
``_s_view``), under autograd through ``layers.to_model``, so their
gradients are summed over the heads' axes.  The chunkwise mLSTM and the
sLSTM's cell loop then run on the rank's heads with no collective
inside."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.ssm import causal_conv

F32 = torch.float32
_MFLOOR = -30.0            # numeric floor for the log-space stabilizer


def mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm
    d_inner = int(x.proj_factor_mlstm * cfg.d_model)
    dh = d_inner // cfg.n_heads
    return d_inner, cfg.n_heads, dh


def _normal(shape, std, dt, gen, dev) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=dev, dtype=F32)
            * std).to(dt)


def _gate_bias(lead, parts, dev) -> torch.Tensor:
    """fp32 gate bias: ``parts`` is ((width, value), ...), concatenated
    and broadcast over the leading stack axes ``lead``."""
    b = torch.cat([torch.full((w,), v, dtype=F32, device=dev)
                   for w, v in parts])
    return b.expand(*lead, b.shape[0]).clone()


def _heads_cut(nh_r: int, nh: int):
    """(first head, mesh axes) of a block holding ``nh_r`` of its ``nh``
    heads; (0, None) when it holds them all."""
    if nh_r == nh:
        return 0, None
    mesh, ax = L.tp_axis(nh_r, nh)
    return mesh.index(ax) * nh_r, ax


def _read(t, ax):
    """A replicated leaf the rank reads a share of: under autograd its
    gradient summed over the heads' axes ``ax``."""
    return t if ax is None else L.to_model(t, ax)


# ==========================================================================
# mLSTM
# ==========================================================================

def init_mlstm_block(cfg: ModelConfig, gen, dev, lead=()) -> dict:
    """mLSTM block params with leading stack axes ``lead``, drawn from the
    seeded ``gen``: the reference's distributions, not its numbers."""
    x = cfg.xlstm
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_inner, nh, dh = mlstm_dims(cfg)
    return {
        "norm": L.init_rmsnorm(d, dt, dev, lead),
        "w_up": L.dense_init((*lead, d, 2 * d_inner), dt, gen, dev),
        "conv_w": _normal((*lead, x.d_conv, d_inner), x.d_conv ** -0.5, dt,
                          gen, dev),
        "conv_b": torch.zeros((*lead, d_inner), dtype=dt, device=dev),
        # head-wise (block-diagonal) q/k/v projections (nh, dh, dh)
        "w_q": _normal((*lead, nh, dh, dh), dh ** -0.5, dt, gen, dev),
        "w_k": _normal((*lead, nh, dh, dh), dh ** -0.5, dt, gen, dev),
        "w_v": _normal((*lead, nh, dh, dh), dh ** -0.5, dt, gen, dev),
        # scalar input/forget gate pre-activations per head
        "w_if": L.dense_init((*lead, d_inner, 2 * nh), dt, gen, dev),
        "b_if": _gate_bias(lead, ((nh, 0.0), (nh, 3.0)), dev),
        "skip": torch.ones((*lead, d_inner), dtype=dt, device=dev),
        "gn": L.init_rmsnorm(dh, dt, dev, lead),             # per-head norm
        "w_down": L.dense_init((*lead, d_inner, d), dt, gen, dev),
    }


def _m_cut(p: dict, cfg: ModelConfig):
    """(d_inner, heads, first head, mesh axes) of the rank's share of an
    mLSTM block whose ``w_down`` holds ``d_inner`` of its rows; axes
    None when the block is whole."""
    _, nh, dh = mlstm_dims(cfg)
    d_r = p["w_down"].shape[-2]
    return (d_r, d_r // dh, *_heads_cut(d_r // dh, nh))


def _m_view(p: dict, cfg: ModelConfig, cut) -> dict:
    """``p`` with the replicated leaves as this rank's share: its heads'
    channels of the conv and ``skip``, its heads' i and f entries of
    ``b_if``, the per-head norm's scale (whole); ``p`` itself when the
    block is whole."""
    d_r, nh_r, h0, ax = cut
    if ax is None:
        return p
    nh, dh = cfg.n_heads, mlstm_dims(cfg)[2]
    q = dict(p)
    for k in ("conv_w", "conv_b", "skip"):
        q[k] = _read(p[k], ax).narrow(-1, h0 * dh, d_r)
    b = _read(p["b_if"], ax)
    q["b_if"] = torch.cat([b.narrow(-1, h0, nh_r),
                           b.narrow(-1, nh + h0, nh_r)], -1)
    q["gn"] = {"scale": _read(p["gn"]["scale"], ax)}
    return q


def _m_proj(p: dict, cfg: ModelConfig, x, cut):
    """(x_main, z): the normed input's up-projection, the rank's heads'
    channels of each on a cut block."""
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    return torch.chunk(_read(xn, cut[3]) @ p["w_up"], 2, dim=-1)


def _m_gates(p: dict, cfg: ModelConfig, x_main, cut) -> torch.Tensor:
    """The i and f pre-activations (..., 2 nh) in fp32 with ``b_if``: on
    a cut block the ranks' partial products summed over the heads' axes
    (fp32, one all-reduce, whose gradient is summed likewise), then the
    rank's heads' i and f."""
    y = x_main @ p["w_if"]
    d_r, nh_r, h0, ax = cut
    if ax is not None:
        nh = cfg.n_heads
        y = L.to_model(L.sum_over(y, ax), ax)
        y = torch.cat([y.narrow(-1, h0, nh_r), y.narrow(-1, nh + h0, nh_r)],
                      -1)
    return y.to(F32) + p["b_if"]


def _m_out(p: dict, cfg: ModelConfig, x, h):
    """The residual and ``w_down``, row-parallel on a cut block."""
    w = p["w_down"]
    return x + L.tp_sum(h @ w, w.shape[-2], mlstm_dims(cfg)[0])


def mlstm_chunked(q, k, v, igate, fgate, chunk: int,
                  state: Optional[Tuple] = None):
    """q, k, v: (B,S,H,D); igate/fgate: (B,S,H) pre-activations.  Returns
    (h (B,S,H,D) fp32, (C (B,H,D,D), n (B,H,D), m (B,H)) final state,
    fp32).  S must be a multiple of ``min(chunk, S)``, as the reference
    asserts; ``state`` (C, n, m) carries a previous call's state."""
    B, S, H, D = q.shape
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"mlstm_chunked: length {S} is not a multiple of "
                         f"the chunk {Lc}")
    nc = S // Lc
    scale = D ** -0.5
    qc = q.reshape(B, nc, Lc, H, D).to(F32) * scale
    kc = k.reshape(B, nc, Lc, H, D).to(F32)
    vc = v.reshape(B, nc, Lc, H, D).to(F32)
    ig = igate.reshape(B, nc, Lc, H).to(F32)
    lf = F.logsigmoid(fgate.reshape(B, nc, Lc, H).to(F32))
    b = torch.cumsum(lf, dim=2)                           # (B,nc,Lc,H)
    # intra-chunk log weights  Lw[t,s] = b_t - b_s + i_s  for s <= t
    bT = b.permute(0, 1, 3, 2)                            # (B,nc,H,Lc)
    igT = ig.permute(0, 1, 3, 2)
    Lw = bT[..., :, None] - bT[..., None, :] + igT[..., None, :]
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    Lw = torch.where(tri, Lw, float("-inf"))
    if state is None:
        C = torch.zeros((B, H, D, D), dtype=F32, device=q.device)
        n = torch.zeros((B, H, D), dtype=F32, device=q.device)
        m = torch.full((B, H), float("-inf"), dtype=F32, device=q.device)
    else:
        C, n, m = (s.to(F32) for s in state)
    hs = []
    for c in range(nc):
        qb, kb, vb, bb, igb, Lwb = (qc[:, c], kc[:, c], vc[:, c], b[:, c],
                                    ig[:, c], Lw[:, c])
        intra_max = Lwb.amax(dim=-1)                      # (B,H,Lc)
        inter = bb.permute(0, 2, 1) + m[..., None]        # (B,H,Lc)
        mt = torch.clamp_min(torch.maximum(intra_max, inter), _MFLOOR)
        wI = torch.exp(Lwb - mt[..., None])               # (B,H,Lc,Lc)
        wX = torch.exp(inter - mt)                        # (B,H,Lc)
        sc = torch.einsum("blhd,bshd->bhls", qb, kb) * wI
        h_num = (torch.einsum("bhls,bshd->blhd", sc, vb)
                 + torch.einsum("blhd,bhde->blhe", qb, C)
                 * wX.permute(0, 2, 1)[..., None])
        denom = (sc.sum(dim=-1)
                 + torch.einsum("blhd,bhd->bhl", qb, n) * wX)   # (B,H,Lc)
        denom = torch.maximum(denom.abs(), torch.exp(-mt))
        hs.append(h_num / denom.permute(0, 2, 1)[..., None])   # (B,Lc,H,D)
        # chunk-end state update
        bL = bb[:, -1]                                    # (B,H)
        st = bL[:, None, :] - bb + igb                    # (B,Lc,H)
        m_new = torch.clamp_min(torch.maximum(bL + m, st.amax(dim=1)),
                                _MFLOOR)
        wS = torch.exp(st - m_new[:, None, :])            # (B,Lc,H)
        carry_w = torch.exp(bL + m - m_new)               # (B,H)
        C = (C * carry_w[..., None, None]
             + torch.einsum("bsh,bshd,bshe->bhde", wS, kb, vb))
        n = n * carry_w[..., None] + torch.einsum("bsh,bshd->bhd", wS, kb)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h, (C, n, m)


def mlstm_block_fwd(p: dict, cfg: ModelConfig, x, *,
                    return_state: bool = False):
    """Full-sequence mLSTM block with its residual.  x: (B, S, d).  With
    ``return_state`` also returns the decode cache entry {"C", "n", "m"
    (fp32), "conv": the last d_conv - 1 pre-conv inputs}."""
    cut = _m_cut(p, cfg)
    p = _m_view(p, cfg, cut)
    d_inner, nh = cut[:2]                 # the rank's, on a cut block
    dh = mlstm_dims(cfg)[2]
    B, S, _ = x.shape
    x_main, z = _m_proj(p, cfg, x, cut)
    conv = F.silu(causal_conv(x_main, p["conv_w"], p["conv_b"]).to(F32)) \
        .to(x.dtype)
    convh = conv.reshape(B, S, nh, dh)
    mainh = x_main.reshape(B, S, nh, dh)
    q = torch.einsum("bshd,hde->bshe", convh, p["w_q"])
    k = torch.einsum("bshd,hde->bshe", convh, p["w_k"])
    v = torch.einsum("bshd,hde->bshe", mainh, p["w_v"])
    gif = _m_gates(p, cfg, x_main, cut)
    ig, fg = torch.chunk(gif, 2, dim=-1)                  # (B,S,nh)
    h, state = mlstm_chunked(q, k, v, ig, fg, chunk=min(256, S))
    h = L.rmsnorm(p["gn"], h.to(x.dtype), cfg.norm_eps)
    h = h.reshape(B, S, d_inner) + conv * p["skip"]
    h = h * F.silu(z.to(F32)).to(x.dtype)
    out = _m_out(p, cfg, x, h)
    if return_state:
        C, n, m = state
        return out, {"C": C, "n": n, "m": m,
                     "conv": x_main[:, -(cfg.xlstm.d_conv - 1):]}
    return out


def _conv_step(win, w, b):
    """The causal conv's last output from the window (B, d_conv, C)."""
    return (torch.einsum("bkc,kc->bc", win.to(F32), w.to(F32))
            + b.to(F32))


def mlstm_block_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    """Sequential mLSTM step.  x: (B, 1, d); cache {"C", "n", "m",
    "conv"}.  Returns (out, new cache entry)."""
    cut = _m_cut(p, cfg)
    p = _m_view(p, cfg, cut)
    d_inner, nh = cut[:2]                 # the rank's, on a cut block
    dh = mlstm_dims(cfg)[2]
    B = x.shape[0]
    x_main, z = _m_proj(p, cfg, x, cut)                   # (B,1,d_inner)
    win = torch.cat([cache["conv"].to(x.dtype), x_main], dim=1)
    conv = F.silu(_conv_step(win, p["conv_w"], p["conv_b"]))[:, None, :] \
        .to(x.dtype)
    convh = conv.reshape(B, nh, dh)
    mainh = x_main.reshape(B, nh, dh)
    q = torch.einsum("bhd,hde->bhe", convh, p["w_q"]).to(F32) * dh ** -0.5
    k = torch.einsum("bhd,hde->bhe", convh, p["w_k"]).to(F32)
    v = torch.einsum("bhd,hde->bhe", mainh, p["w_v"]).to(F32)
    gif = _m_gates(p, cfg, x_main, cut)[:, 0]
    ig, fg = torch.chunk(gif, 2, dim=-1)                  # (B,nh)
    lf = F.logsigmoid(fg)
    C, n, m = (cache["C"].to(F32), cache["n"].to(F32), cache["m"].to(F32))
    m_new = torch.clamp_min(torch.maximum(lf + m, ig), _MFLOOR)
    wf = torch.exp(lf + m - m_new)
    wi = torch.exp(ig - m_new)
    C = (C * wf[..., None, None]
         + wi[..., None, None] * k[..., None] * v[..., None, :])
    n = n * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(),
                        torch.exp(-m_new))[..., None]
    h = (num / den).to(x.dtype)
    h = L.rmsnorm(p["gn"], h, cfg.norm_eps).reshape(B, 1, d_inner)
    h = h + conv * p["skip"]
    h = h * F.silu(z.to(F32)).to(x.dtype)
    out = _m_out(p, cfg, x, h)
    return out, {"C": C, "n": n, "m": m_new, "conv": win[:, 1:]}


# ==========================================================================
# sLSTM
# ==========================================================================

def init_slstm_block(cfg: ModelConfig, gen, dev, lead=()) -> dict:
    """sLSTM block params with leading stack axes ``lead``: the
    reference's distributions, not its numbers."""
    x = cfg.xlstm
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    d_ff = int(x.proj_factor_slstm * d)
    return {
        "norm": L.init_rmsnorm(d, dt, dev, lead),
        "conv_w": _normal((*lead, x.d_conv, d), x.d_conv ** -0.5, dt, gen,
                          dev),
        "conv_b": torch.zeros((*lead, d), dtype=dt, device=dev),
        "w_gates": L.dense_init((*lead, d, 4 * d), dt, gen, dev),  # z,i,f,o
        # block-diagonal recurrent weights per head: (4, nh, dh, dh)
        "r_gates": _normal((*lead, 4, nh, dh, dh), dh ** -0.5, dt, gen, dev),
        "b_gates": _gate_bias(lead, ((2 * d, 0.0), (d, 3.0), (d, 0.0)), dev),
        "gn": L.init_rmsnorm(dh, dt, dev, lead),
        "up": L.init_swiglu(gen, d, d_ff, dt, dev, lead),
    }


def _slstm_cell(Wx, r_gates, h_prev, c_prev, n_prev, m_prev, nh, dh):
    """One sLSTM step.  Wx: (B, 4, nh, dh) input pre-activations (+bias)."""
    B = Wx.shape[0]
    hp = h_prev.reshape(B, nh, dh)
    rec = torch.einsum("ghde,bhd->gbhe", r_gates.to(F32), hp)
    pre = Wx.permute(1, 0, 2, 3) + rec                    # (4,B,nh,dh)
    zt = torch.tanh(pre[0])
    it = pre[1]                                           # log-space gates
    lf = F.logsigmoid(pre[2])
    ot = torch.sigmoid(pre[3])
    m_new = torch.maximum(lf + m_prev, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(lf + m_prev - m_new)
    c = f_ * c_prev + i_ * zt
    n = torch.clamp_min(f_ * n_prev + i_, 1e-6)
    h = ot * c / n
    return h.reshape(B, nh * dh), c, n, m_new


def _s_cut(p: dict, cfg: ModelConfig):
    """(width, heads, first head, mesh axes) of the rank's share of an
    sLSTM block whose ``w_gates`` holds 4 x ``width`` of its columns;
    axes None when the block is whole."""
    dh = cfg.d_model // cfg.n_heads
    d_r = p["w_gates"].shape[-1] // 4
    return (d_r, d_r // dh, *_heads_cut(d_r // dh, cfg.n_heads))


def _s_view(p: dict, cfg: ModelConfig, cut) -> dict:
    """``p`` with the replicated leaves as this rank's share: its heads
    of ``r_gates``, its heads' entries of each stream of ``b_gates``,
    the per-head norm's scale (whole); ``p`` itself when the block is
    whole.  The conv reads the whole input."""
    d_r, nh_r, h0, ax = cut
    if ax is None:
        return p
    q = dict(p)
    q["r_gates"] = _read(p["r_gates"], ax).narrow(-3, h0, nh_r)
    q["b_gates"] = SH.packed_slice(_read(p["b_gates"], ax), -1,
                                   SH.xlstm_parts(cfg, "w_gates"),
                                   cfg.n_heads // nh_r, h0 // nh_r)
    q["gn"] = {"scale": _read(p["gn"]["scale"], ax)}
    return q


def _slstm_gate_inputs(p, cfg, xn, conv, cut):
    """Project the (raw, conv) streams into the 4 gate pre-activations
    (the rank's heads' on a cut block, whose whole inputs enter through
    ``layers.to_model``)."""
    d_r, ax = cut[0], cut[3]
    wg = p["w_gates"].reshape(cfg.d_model, 4, d_r)
    xn, conv = _read(xn, ax), _read(conv, ax)
    Wx = torch.stack([xn @ wg[:, 0], conv @ wg[:, 1], conv @ wg[:, 2],
                      xn @ wg[:, 3]], dim=-2).to(F32)     # (..., 4, d_r)
    return Wx + p["b_gates"].reshape(4, d_r)


def _s_out(p: dict, cfg: ModelConfig, x, hs, cut):
    """The residual and the SwiGLU ``up`` over the heads' outputs ``hs``
    (normed), gathered whole over the heads' axes on a cut block."""
    if cut[3] is not None:
        hs = L.gather_over(hs, -1, cut[3])
    return x + L.swiglu(p["up"], hs, SH.xlstm_dims(cfg)[3])


def slstm_block_fwd(p: dict, cfg: ModelConfig, x, *,
                    return_state: bool = False):
    """Full-sequence sLSTM block with its residual: one cell step per
    position.  With ``return_state`` also returns the decode cache entry
    {"h", "c", "n", "m" (fp32), "conv_win": the last d_conv - 1 normed
    inputs} (on a mesh the rank's heads of all but ``conv_win``)."""
    cut = _s_cut(p, cfg)
    p = _s_view(p, cfg, cut)
    d, nh = cut[:2]                       # the rank's, on a cut block
    dh = cfg.d_model // cfg.n_heads
    B, S, _ = x.shape
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    conv = F.silu(causal_conv(xn, p["conv_w"], p["conv_b"]).to(F32)) \
        .to(x.dtype)
    Wx = _slstm_gate_inputs(p, cfg, xn, conv, cut).reshape(B, S, 4, nh, dh)
    h = torch.zeros((B, d), dtype=F32, device=x.device)
    c = torch.zeros((B, nh, dh), dtype=F32, device=x.device)
    n = torch.full((B, nh, dh), 1e-6, dtype=F32, device=x.device)
    m = torch.zeros((B, nh, dh), dtype=F32, device=x.device)
    r_gates = p["r_gates"].to(F32)         # cast once, not once a step
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_cell(Wx[:, t], r_gates, h, c, n, m, nh, dh)
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)               # (B,S,d)
    hs = L.rmsnorm(p["gn"], hs.reshape(B, S, nh, dh),
                   cfg.norm_eps).reshape(B, S, d)
    out = _s_out(p, cfg, x, hs, cut)
    if return_state:
        return out, {"h": h, "c": c, "n": n, "m": m,
                     "conv_win": xn[:, -(cfg.xlstm.d_conv - 1):]}
    return out


def slstm_block_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    """One sLSTM step.  x: (B, 1, d); cache {"h", "c", "n", "m",
    "conv_win"}.  Returns (out, new cache entry)."""
    cut = _s_cut(p, cfg)
    p = _s_view(p, cfg, cut)
    d, nh = cut[:2]                       # the rank's, on a cut block
    dh = cfg.d_model // cfg.n_heads
    B = x.shape[0]
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)[:, 0]      # (B, d)
    win = torch.cat([cache["conv_win"].to(x.dtype), xn[:, None]], dim=1)
    conv = F.silu(_conv_step(win, p["conv_w"], p["conv_b"])).to(x.dtype)
    Wx = _slstm_gate_inputs(p, cfg, xn, conv, cut).reshape(B, 4, nh, dh)
    h, c, n, m = _slstm_cell(Wx, p["r_gates"], cache["h"].to(F32),
                             cache["c"].to(F32), cache["n"].to(F32),
                             cache["m"].to(F32), nh, dh)
    hs = L.rmsnorm(p["gn"], h.to(x.dtype).reshape(B, 1, nh, dh),
                   cfg.norm_eps).reshape(B, 1, d)
    out = _s_out(p, cfg, x, hs, cut)
    return out, {"h": h, "c": c, "n": n, "m": m, "conv_win": win[:, 1:]}
