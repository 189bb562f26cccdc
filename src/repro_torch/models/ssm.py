"""Mamba2 (SSD) block: the twin of the JAX package's ``models/ssm.py``.

State-space recurrence per head h with state size N and head dim P:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t (x) x_t)        (P, N)
    y_t = C_t . h_t + D * x_t
The full-sequence block (``mamba2_fwd``, every prefill) runs the chunked
SSD scan through ``kernels.ops.ssm_chunk_scan``: the hand-written Hopper
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
Under autograd the scan runs inside ``SSDChunkScan``: the kernel's
forward, and a backward through the plain version (the reference trains
through its jnp ``ssd_chunked``; no Pallas backward exists to port).
The single-token step (``mamba2_decode``) is plain torch, as in the
reference, which has no kernel for it.  ``A_log``, ``D`` and
``dt_bias`` stay fp32 in any param dtype, as the reference keeps them.

Under a mesh (``launch.sharding``) a block holds the rank's whole SSM
heads: ``in_proj`` its heads' columns of z, x and dt with B and C whole
(``sharding.PackedCut``; one group, which every head reads),
``out_proj`` its heads' rows (row-parallel, one all-reduce).  The
replicated ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and
norm scale are read as the rank's share (``_rank_view``), and the
gated RMSNorm over the whole ``d_inner`` sums the ranks' squares in one
fp32 all-reduce.  The SSD scan then runs on the rank's heads.  Under
autograd each whole leaf the rank reads a share of, the B and C columns
of ``in_proj`` and the block's input enter through ``layers.to_model``
(their gradients are partial sums over the heads' axes), and the
norm's sum of squares has the all-reduce for its backward too.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import sharding as SH
from repro_torch.models import layers as L

F32 = torch.float32


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


def init_mamba2(cfg: ModelConfig, gen, device, lead=()) -> dict:
    """Mamba2 params with leading stack axes ``lead``, drawn from the
    seeded ``gen``: the reference's distributions (``dt_bias`` the
    inverse softplus of dt ~ U[1e-3, 1e-1], ``A_log = log U[1, 16]``),
    not its numbers."""
    s = cfg.ssm
    dt = L.dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_inner, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    conv_ch = d_inner + 2 * gn

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((*lead, nh), generator=gen,
                                           device=device, dtype=F32)

    u = uniform(1e-3, 1e-1)
    return {
        "in_proj": L.dense_init((*lead, d, 2 * d_inner + 2 * gn + nh), dt,
                                gen, device),
        "conv_w": (torch.randn((*lead, s.d_conv, conv_ch), generator=gen,
                               device=device, dtype=F32)
                   / s.d_conv ** 0.5).to(dt),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones((*lead, nh), dtype=F32, device=device),
        "dt_bias": u + torch.log(-torch.expm1(-u)),
        "norm": {"scale": torch.ones((*lead, d_inner), dtype=dt,
                                     device=device)},
        "out_proj": L.dense_init((*lead, d_inner, d), dt, gen, device),
    }


def _cut(p: dict, cfg: ModelConfig):
    """(d_inner, heads, first head, mesh axes) of the rank's share of a
    block whose ``out_proj`` holds ``d_inner`` of its rows; axes None
    when the block is whole."""
    d_inner, nh = _dims(cfg)
    d_r = p["out_proj"].shape[-2]
    if d_r == d_inner:
        return d_inner, nh, 0, None
    nh_r = d_r // cfg.ssm.head_dim
    mesh, ax = L.tp_axis(nh_r, nh)
    return d_r, nh_r, mesh.index(ax) * nh_r, ax


def _rank_view(p: dict, cfg: ModelConfig, cut) -> dict:
    """``p`` with the replicated leaves as this rank's share: the conv's
    channels x | B | C (its heads' x, B and C whole), its heads' A_log,
    D and dt_bias, its d_inner of the norm's scale; and ``in_proj``'s B
    and C columns.  Under autograd each leaf the rank reads part of
    enters through ``layers.to_model``, so its gradient is summed over
    the heads' axes (the other ranks' shares, and their parts of B and
    C's).  ``p`` itself when the block is whole."""
    d_r, nh_r, h0, ax = cut
    if ax is None:
        return p
    s = cfg.ssm
    n, i = _dims(cfg)[1] // nh_r, h0 // nh_r
    parts = SH.mamba_parts(cfg, "conv")

    def read(t):
        return L.to_model(t, ax)
    q = dict(p)
    q["conv_w"] = SH.packed_slice(read(p["conv_w"]), -1, parts, n, i)
    q["conv_b"] = SH.packed_slice(read(p["conv_b"]), -1, parts, n, i)
    for k in ("A_log", "D", "dt_bias"):
        q[k] = read(p[k]).narrow(-1, h0, nh_r)
    q["norm"] = {"scale": read(p["norm"]["scale"]).narrow(
        -1, h0 * s.head_dim, d_r)}
    w = p["in_proj"]
    if L._graph(w):
        a, b = 2 * d_r, 2 * d_r + 2 * s.n_groups * s.d_state
        q["in_proj"] = torch.cat([w[..., :a], read(w[..., a:b]),
                                  w[..., b:]], -1)
    return q


def _split_proj(p, cfg, x, cut):
    s = cfg.ssm
    d_r, nh_r, _, ax = cut
    gn = s.n_groups * s.d_state
    if ax is not None:
        x = L.to_model(x, ax)
    zxbcdt = x @ p["in_proj"]
    return torch.split(zxbcdt, [d_r, d_r, gn, gn, nh_r], dim=-1)


def _gated_norm(p, cfg, y, z, cut):
    """The reference's ``rmsnorm(norm, y * silu(z))`` over the whole
    ``d_inner``: on a cut block the ranks' sums of squares are summed
    over the heads' axes in fp32 (one all-reduce; under autograd its
    backward sums the gradient likewise)."""
    g = y * F.silu(z.to(F32)).to(y.dtype)
    ax = cut[3]
    if ax is None:
        return L.rmsnorm(p["norm"], g, cfg.norm_eps)
    gf = g.to(F32)
    ss = L.sum_over(gf.square().sum(-1, keepdim=True), ax)
    var = L.to_model(ss, ax) / _dims(cfg)[0]
    out = gf * torch.rsqrt(var + cfg.norm_eps)
    return (out * p["norm"]["scale"].to(F32)).to(g.dtype)


def _out(p, cfg, y, cut):
    """``out_proj``, row-parallel on a cut block."""
    return L.tp_sum(y @ p["out_proj"], cut[0], _dims(cfg)[0])


def causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(K):
        out = out + xp[:, i:i + S].to(F32) * w[i].to(F32)
    return (out + b.to(F32)).to(x.dtype)


class SSDChunkScan(torch.autograd.Function):
    """The chunked SSD scan under autograd: the forward runs
    ``ops.ssm_chunk_scan`` (the CUDA kernel for a CUDA tensor) and saves
    its inputs; the backward recomputes the scan through the plain
    version (``ref.ssm_chunk_scan_ref``, differentiable PyTorch) and
    returns its gradients, as ``models.flash.FlashAttention`` does for
    flash.  The twin of training through the reference's jnp
    ``ssd_chunked`` under ``jax.checkpoint``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        y, state = ops.ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y, state = ref.ssm_chunk_scan_ref(*inputs, ctx.chunk)
            grads = iter(torch.autograd.grad((y, state), wrt, (dy, dstate)))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan through ``ops.ssm_chunk_scan``; under autograd
    (grad enabled and an input that requires grad) through
    ``SSDChunkScan``.

    xh: (B,S,H,P); dt: (B,S,H) fp32 (post-softplus); A: (H,) negative;
    Bm, Cm: (B,S,G,N) with G dividing H (head h reads group h // (H/G);
    the reference repeats them to (B,S,H,N) first, which is G == H here).
    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32).  S must be a
    multiple of ``min(chunk, S)``, as the reference asserts.  On CUDA an
    ``h0`` raises: the kernel starts from a zero state."""
    if (h0 is None and torch.is_grad_enabled()
            and any(t.requires_grad for t in (xh, dt, A, Bm, Cm))):
        return SSDChunkScan.apply(xh, dt, A, Bm, Cm, chunk)
    return ops.ssm_chunk_scan(xh, dt, A, Bm, Cm, chunk=chunk, h0=h0)


def mamba2_fwd(p: dict, cfg: ModelConfig, x, *, return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, S, d).  With ``return_state``
    also returns ``{"ssm": (B,H,P,N) fp32, "conv": (B, d_conv-1,
    conv_ch)}``, the pre-conv inputs of the last d_conv - 1 positions
    (on a mesh the rank's heads H and channels x | B | C)."""
    s = cfg.ssm
    cut = _cut(p, cfg)
    p = _rank_view(p, cfg, cut)
    d_inner, nh = cut[:2]
    gn = s.n_groups * s.d_state
    B, S, _ = x.shape
    z, xin, Bm, Cm, dt = _split_proj(p, cfg, x, cut)
    xbc_pre = torch.cat([xin, Bm, Cm], dim=-1)           # pre-conv (cached)
    xbc = F.silu(causal_conv(xbc_pre, p["conv_w"], p["conv_b"]).to(F32)) \
        .to(x.dtype)
    xin, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    # views of xbc, read by the kernel through their strides: B and C stay
    # at group level (no copy per head)
    xh = xin.reshape(B, S, nh, s.head_dim)
    Bg = Bm.reshape(B, S, s.n_groups, s.d_state)
    Cg = Cm.reshape(B, S, s.n_groups, s.d_state)
    dtv = F.softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ssd_chunked(xh, dtv, A, Bg, Cg, s.chunk)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = y.to(x.dtype).reshape(B, S, d_inner)
    out = _out(p, cfg, _gated_norm(p, cfg, y, z, cut), cut)
    if return_state:
        return out, {"ssm": state, "conv": xbc_pre[:, -(s.d_conv - 1):]}
    return out


def mamba2_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    """Single-token recurrent step.  x: (B, 1, d).
    cache: {"ssm": (B,H,P,N) fp32, "conv": (B, d_conv-1, conv_ch)}.
    Returns (out, new cache); the caller writes the new cache back."""
    s = cfg.ssm
    cut = _cut(p, cfg)
    p = _rank_view(p, cfg, cut)
    d_inner, nh = cut[:2]
    gn = s.n_groups * s.d_state
    B = x.shape[0]
    z, xin, Bm, Cm, dt = _split_proj(p, cfg, x, cut)
    xbc = torch.cat([xin, Bm, Cm], dim=-1)               # (B,1,conv_ch)
    win = torch.cat([cache["conv"], xbc], dim=1)         # (B,d_conv,ch)
    conv_out = (torch.einsum("bkc,kc->bc", win.to(F32), p["conv_w"].to(F32))
                + p["conv_b"].to(F32))
    xbc = F.silu(conv_out)[:, None, :].to(x.dtype)
    new_conv = win[:, 1:]
    xin2, Bm2, Cm2 = torch.split(xbc, [d_inner, gn, gn], dim=-1)

    xh = xin2.reshape(B, nh, s.head_dim).to(F32)
    rep = nh // s.n_groups
    Bh = Bm2.reshape(B, s.n_groups, s.d_state).repeat_interleave(rep, dim=1) \
        .to(F32)
    Ch = Cm2.reshape(B, s.n_groups, s.d_state).repeat_interleave(rep, dim=1) \
        .to(F32)
    dtv = F.softplus(dt.to(F32)[:, 0] + p["dt_bias"])   # (B,H)
    A = -torch.exp(p["A_log"])
    h = cache["ssm"].to(F32)
    decay = torch.exp(dtv * A)                           # (B,H)
    h = (h * decay[..., None, None]
         + torch.einsum("bh,bhn,bhp->bhpn", dtv, Bh, xh))
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    out = _out(p, cfg, _gated_norm(p, cfg, y, z, cut), cut)
    return out, {"ssm": h, "conv": new_conv}
