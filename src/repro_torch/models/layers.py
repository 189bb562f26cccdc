"""Common layers: the truncated-normal init, norms (RMSNorm, and
whisper's LayerNorm), the SwiGLU and the biased GELU MLPs, rotary
embeddings (with Qwen2-VL's M-RoPE sections), whisper's sinusoidal
positions and (un)embedding.  The twin of the
JAX package's ``models/layers.py``: functional, params as plain dicts of
tensors, norm/softmax math in fp32 and matmuls in the activation
dtype.

Under a mesh (``models.pspec.mesh_rules``) a weight may hold only this
rank's slice (``launch.sharding``): a row-parallel product's partial
sums meet in ``tp_sum``, a vocab-parallel table's lookup and logits in
the mesh's exact ``combine`` and ``gather``, each over the mesh axes the
weight is cut over (``tp_axis``: "model", or under ``infer-tp2`` both
axes or "data", as the count divides).  Under autograd (training
on a mesh) these are ``torch.autograd.Function``s, Megatron's conjugate
pairs [arXiv:1909.08053]: ``to_model`` (identity forward, an all-reduce
over "model" backward) before each column-parallel product, whose
replicated input takes partial gradients from every rank; ``tp_sum``
(an all-reduce forward, identity backward); the lookup's join
(identity backward: each rank's rows of the table get their own
gradient); the logits' gather (a ``narrow`` backward); ``read_weight``
where the model reads an FSDP-cut weight or the unembedding weight
(``gathered``: the exact gather over the FSDP axes forward, "data" or
("pod", "data"), the gradient summed over the batch cut backward);
``batch_sum`` (the sum over the ranks that hold other rows of the
batch, identity backward) for the loss and the MoE's routing statistics; and ``exchange`` (the MoE's
all-to-all with the experts' owners, the reverse exchange backward).
Without autograd they are the serving path's collectives, unchanged."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import pspec as PS

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _trunc_normal(shape, gen, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], by inverting the CDF."""
    lo = 0.5 * (1 + math.erf(-3 / math.sqrt(2)))
    u = torch.rand(shape, generator=gen, device=device, dtype=F32)
    u = lo + (1 - 2 * lo) * u
    return torch.erfinv(2 * u - 1) * math.sqrt(2)


def dense_init(shape, dtype, gen, device, *, scale: float = 1.0,
               fan_in=None) -> torch.Tensor:
    """Truncated-normal init with std ``scale / sqrt(fan_in)``.  ``shape``
    may carry leading stack axes (layers, units): fan-in is then
    ``shape[-2]``, as the JAX ``dense_init`` under ``vmap`` sees it,
    unless ``fan_in`` is given.  Drawn one matrix at a time, so the fp32
    draw never holds more than one matrix (a zamba2-7b ``in_proj`` stack
    would be 16 GB in fp32)."""
    std = scale / (shape[-2] if fan_in is None else fan_in) ** 0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:                     # shapes only (``param_shapes``)
        return out
    for m in out.view(-1, *shape[-2:]):
        m.copy_(_trunc_normal(shape[-2:], gen, device) * std)
    return out


def init_rmsnorm(d: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32)).to(dt)


def init_layernorm(d: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm with mean and (biased) variance in fp32, cast back to
    x's dtype, as the reference's ``layernorm``."""
    dt = x.dtype
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(F32) + params["bias"].to(F32)).to(dt)


def norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm when the tree has a ``bias`` (encoder-decoder), else
    RMSNorm: the tree decides, as in the reference."""
    if "bias" in params:
        return layernorm(params, x, eps)
    return rmsnorm(params, x, eps)


def init_norm(d: int, dtype, device, use_layernorm: bool = False,
              lead=()) -> dict:
    init = init_layernorm if use_layernorm else init_rmsnorm
    return init(d, dtype, device, lead)


def init_swiglu(gen, d_model: int, d_ff: int, dtype, device,
                lead=()) -> dict:
    """SwiGLU MLP params, drawn in the reference's order (gate, up,
    down), with leading stack axes ``lead``."""
    return {"w_gate": dense_init((*lead, d_model, d_ff), dtype, gen, device),
            "w_up": dense_init((*lead, d_model, d_ff), dtype, gen, device),
            "w_down": dense_init((*lead, d_ff, d_model), dtype, gen, device)}


def tp_axis(local: int, whole: int, logical: str = "model") -> tuple:
    """(mesh, axes): the installed mesh and the mesh axes (a spec entry:
    one name, or a tuple of names) over which a weight holding the
    rank's ``local`` of ``whole`` rows or entries is cut under
    ``logical`` ("model", or "expert" for the experts), which the
    installed rules map to "model" under the serving map and
    ``baseline``, and to ("data", "model") or "data" under ``infer-tp2``
    (``pspec.entry_of``)."""
    mesh = PS.current_mesh()
    axes = (None if mesh is None or local <= 0 or whole % local
            else PS.entry_of(logical, whole // local))
    if axes is None:
        raise RuntimeError(f"a weight cut to {local} of {whole} needs the "
                           "mesh it was cut for installed (mesh_rules)")
    return mesh, axes


def _graph(x: torch.Tensor) -> bool:
    """Whether ``x`` is on an autograd graph being recorded."""
    return torch.is_grad_enabled() and x.requires_grad


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over ``axis`` backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.mesh.all_reduce(g.to(F32, copy=True), ctx.axis)
        return s.to(g.dtype), None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``axis`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Combine(torch.autograd.Function):
    """``Mesh.combine`` over ``axis`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.combine(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """The exact gather along ``dim`` over ``axis`` forward; backward
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis, ctx.k = mesh, dim, axis, x.shape[dim]
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return g.narrow(ctx.dim, i * ctx.k, ctx.k), None, None, None


def gather_over(x: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The exact gather of the ranks' equal slices of ``x`` along ``dim``
    over the installed mesh's ``axes``; under autograd backward this
    rank's slice of the gradient (which must be the same on every rank
    of ``axes``: what reads the gathered tensor is replicated, or enters
    a column-parallel product through ``to_model``)."""
    mesh = PS.current_mesh()
    if _graph(x):
        return _Gather.apply(x, mesh, dim, axes)
    return mesh.gather(x, dim, axes)


class _Read(torch.autograd.Function):
    """A weight read by a training mesh's model: forward the exact gather
    over the FSDP cut's mesh axes ``over`` along ``dim`` (None: the
    weight itself); backward the gradient summed over ``axes`` (a
    reduce-scatter over ``over`` for an FSDP cut, which sums over those
    whether or not they are among ``axes``, an all-reduce over the
    others), in fp32, then cast back."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axes, over):
        ctx.mesh, ctx.dim, ctx.axes, ctx.over = mesh, dim, axes, over
        return x.view_as(x) if dim is None else mesh.gather(x, dim, over)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        s = g.to(F32, copy=True)
        rest = ctx.axes
        if dim is not None:
            s = mesh.reduce_scatter(s, dim, ctx.over)
            cut = set(ctx.over if isinstance(ctx.over, tuple)
                      else (ctx.over,))
            rest = tuple(a for a in rest if a not in cut)
        if rest:
            s = mesh.all_reduce(s, rest)
        return s.to(g.dtype), None, None, None, None


def to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` entering a column-parallel product (its weight cut over the
    mesh axes ``axis``, ``tp_axis``'s): under autograd the gradient it
    gets there is summed over them; otherwise ``x`` itself."""
    if not _graph(x):
        return x
    return _ToModel.apply(x, PS.current_mesh(), axis)


def tp_sum(y: torch.Tensor, local: int, whole: int,
           logical: str = "model") -> torch.Tensor:
    """``y`` summed over the weight's axes (``tp_axis``) when it is a
    row-parallel product's partial (its weight holds ``local`` of
    ``whole`` contraction rows), in fp32 and cast back; ``y`` itself
    when the weight is whole."""
    if local == whole:
        return y
    return sum_over(y, tp_axis(local, whole, logical)[1])


def sum_over(y: torch.Tensor, axes) -> torch.Tensor:
    """``y`` summed over the installed mesh's ``axes`` (a spec entry) in
    fp32 and cast back; under autograd identity backward (each rank's
    partial gets the whole gradient)."""
    mesh = PS.current_mesh()
    if _graph(y):
        return _AllReduce.apply(y.to(F32), mesh, axes).to(y.dtype)
    return mesh.all_reduce(y.to(F32), axes).to(y.dtype)


class _Exchange(torch.autograd.Function):
    """``Mesh.all_to_all`` along dim 0 over ``axes`` forward; backward
    the same exchange (its own inverse), each slice's gradient back to
    the rank that sent it."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, 0, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g, 0, ctx.axes), None, None


def exchange(x: torch.Tensor, axes) -> torch.Tensor:
    """Slice ``j`` of ``x`` (dim 0, one a rank of the installed mesh's
    ``axes``) to the rank at index ``j`` there, and theirs here
    (``Mesh.all_to_all``), under autograd with its reverse backward."""
    mesh = PS.current_mesh()
    if _graph(x):
        return _Exchange.apply(x, mesh, axes)
    return mesh.all_to_all(x, 0, axes)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks holding other rows of the batch
    (``pspec.batch_axes``), identity backward: each rank's rows take
    their own gradient, and the step sums the ranks' gradients.  ``x``
    itself when no axis cuts the batch."""
    axes = PS.batch_axes()
    if not axes:
        return x
    return _AllReduce.apply(x, PS.current_mesh(), axes)


def read_weight(t: torch.Tensor, dim, axes=None, over=None
                ) -> torch.Tensor:
    """A weight where a training mesh's model reads it: the whole of an
    FSDP-cut one (this rank's slice along ``dim`` of the cut over the
    mesh axes ``over``, the "fsdp" entry's: "data", or ("pod", "data");
    None: not cut), and under autograd its gradient summed over ``axes``
    (default the batch cut's; an expert block's leaves out the axes its
    exchange covered, ``sharding.grad_axes``) there, before any rounding
    the read's consumer applies to it (the unembedding's bf16), as on
    one rank."""
    mesh = PS.current_mesh()
    if _graph(t):
        return _Read.apply(t, mesh, dim,
                           PS.batch_axes() if axes is None else axes, over)
    return t if dim is None else mesh.gather(t, dim, over)


def gathered(tree, prefix: tuple):
    """``tree`` (the params under ``prefix``, a layer's views or a leaf)
    with each leaf of the installed read plan (``pspec.read_plan``:
    {path: (FSDP dim, gradient axes, FSDP axes)}) through
    ``read_weight``; the tree itself without a plan.  A block calls
    this where it reads its
    weights, inside remat's checkpoint, so the backward gathers again."""
    plan = PS.read_plan()
    if not plan:
        return tree
    if isinstance(tree, dict):
        return {k: gathered(v, prefix + (k,)) for k, v in tree.items()}
    if prefix not in plan:
        return tree
    return read_weight(tree, *plan[prefix])


def _column_input(x: torch.Tensor, local: int, whole) -> torch.Tensor:
    """``x`` entering a product whose weight holds ``local`` of
    ``whole`` (None: its own) output columns: through ``to_model`` over
    the weight's axes when it is cut."""
    if local == (whole or local):
        return x
    return to_model(x, tp_axis(local, whole)[1])


def swiglu(params: dict, x: torch.Tensor, d_ff=None) -> torch.Tensor:
    """SwiGLU MLP; ``d_ff``: its whole width when ``params`` may be this
    rank's slice (``w_down`` row-parallel)."""
    x = _column_input(x, params["w_gate"].shape[-1], d_ff)
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.to(F32)).to(x.dtype) * u
    w = params["w_down"]
    return tp_sum(h @ w, w.shape[-2], d_ff or w.shape[-2])


def init_gelu_mlp(gen, d_model: int, d_ff: int, dtype, device,
                  lead=()) -> dict:
    """Biased GELU MLP params (GPT-BigCode / whisper style), drawn in
    the reference's order (up, down), biases zero, with leading stack
    axes ``lead``."""
    return {"w_up": dense_init((*lead, d_model, d_ff), dtype, gen, device),
            "b_up": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
            "w_down": dense_init((*lead, d_ff, d_model), dtype, gen, device),
            "b_down": torch.zeros((*lead, d_model), dtype=dtype,
                                  device=device)}


def gelu_mlp(params: dict, x: torch.Tensor, d_ff=None) -> torch.Tensor:
    """The reference's ``gelu_mlp``: ``jax.nn.gelu`` is the tanh
    approximation by default, in fp32, cast back to x's dtype.  ``d_ff``
    as in ``swiglu``; ``b_down`` is added once, after the sum."""
    x = _column_input(x, params["w_up"].shape[-1], d_ff)
    h = x @ params["w_up"] + params["b_up"]
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    w = params["w_down"]
    return tp_sum(h @ w, w.shape[-2], d_ff or w.shape[-2]) + params["b_down"]


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """Rotate ``x`` of shape (batch, seq, heads, head_dim) by
    ``positions`` (batch, seq), or for M-RoPE [arXiv:2409.12191] by
    (3, batch, seq) (temporal, height, width) positions, whose angles
    fill the head_dim/2 frequency slots in ``mrope_sections`` slices."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (hd/2,)
    if positions.dim() == 3:                                      # M-RoPE
        if mrope_sections is None:
            raise ValueError("apply_rope: (3, B, S) positions need "
                             "mrope_sections")
        st, sh, sw = mrope_sections
        if st + sh + sw != head_dim // 2:
            raise ValueError(f"apply_rope: sections {mrope_sections} do not "
                             f"fill head_dim / 2 = {head_dim // 2}")
        ang = positions.to(F32)[..., None] * freqs                # (3,b,s,hd/2)
        angles = torch.cat([ang[0, ..., :st], ang[1, ..., st:st + sh],
                            ang[2, ..., st + sh:]], dim=-1)
    else:
        angles = positions.to(F32)[..., None] * freqs             # (b,s,hd/2)
    cos = torch.cos(angles)[..., None, :]                         # (b,s,1,hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d_model: int, device) -> torch.Tensor:
    """Whisper-style sinusoidal position table (n_pos, d_model), fp32,
    with the reference's ``max(d // 2 - 1, 1)`` denominator."""
    pos = torch.arange(n_pos, dtype=F32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=F32, device=device)[None, :]
    step = (torch.log(torch.tensor(10000.0, dtype=F32, device=device))
            / max(d_model // 2 - 1, 1))                    # fp32, as jnp's
    inv = torch.exp(-dim * step)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_init(shape, dtype, gen, device) -> torch.Tensor:
    """Normal init with std 0.02 (the reference's ``embed_init``)."""
    return (torch.randn(shape, generator=gen, device=device, dtype=F32)
            * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          vocab_size=None) -> torch.Tensor:
    """Rows ``tokens`` of ``table``.  Vocab-parallel when ``table`` holds
    this rank's rows of a ``vocab_size`` vocabulary: each rank looks up
    the tokens it holds, zeros the others, and the mesh combines the
    rows exactly."""
    tokens = tokens.long()
    V = table.shape[0]
    if vocab_size is None or V == vocab_size:
        return table[tokens]
    mesh, axis = tp_axis(V, vocab_size)
    ids = tokens - mesh.index(axis) * V
    out = table[ids.clamp(0, V - 1)]
    outside = (ids < 0) | (ids >= V)
    if _graph(out):
        out = torch.where(outside[..., None], torch.zeros((), dtype=out.dtype,
                                                          device=out.device),
                          out)
        return _Combine.apply(out, mesh, axis)
    out[outside] = 0
    return mesh.combine(out, axis)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            transpose: bool, vocab_size=None, path=None) -> torch.Tensor:
    """Project hidden states (b, s, d) to fp32 vocab logits.  The weight
    is rounded to bf16 first, as the JAX package does, and the product
    runs in the promoted type of the two (fp32 for fp32 activations).
    Vocab-parallel when the weight holds this rank's share of a
    ``vocab_size`` vocabulary: local logits, gathered exactly.  ``path``:
    the weight's param path, gathered whole over its FSDP axes after the
    rounding where FSDP cuts it (``gathered``), so its gradient is
    summed over them before it is rounded, as on one rank."""
    w = table_or_head.to(torch.bfloat16)
    dt = torch.promote_types(x.dtype, w.dtype)
    w = w.to(dt)
    if path is not None:
        w = gathered(w, path)
    V = w.shape[0 if transpose else -1]
    cut = vocab_size is not None and V != vocab_size
    if not cut:
        return (x.to(dt) @ (w.t() if transpose else w)).to(F32)
    mesh, axis = tp_axis(V, vocab_size)
    x = to_model(x, axis)
    logits = (x.to(dt) @ (w.t() if transpose else w)).to(F32)
    if _graph(logits):
        return _Gather.apply(logits, mesh, -1, axis)
    return mesh.gather(logits, -1, axis)
