"""Load the JAX package's params and KV caches into the port.

The JAX side hands over its pytree as nested dicts of numpy arrays
(``jax.device_get``), keyed by the same tree paths the port uses
(``embed``, ``final_norm/scale``, ``blocks/attn/w_q``, ...).  Leaves are
copied to ``device``; bf16 leaves (numpy's ``bfloat16`` extension type,
which torch cannot read) go by bit-view: the 16-bit pattern is viewed as
int16, copied, and viewed back as ``torch.bfloat16`` — no rounding
anywhere.  The port itself never imports JAX: the tests make the
numpy tree."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.layers import dtype_of


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (never a view of ``a``'s memory: the
    port writes pools in place, and JAX's host arrays are read-only)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of tensors: a params
    subtree, a JAX paged KV pool ``{"blocks": {"k", "v"}}`` with leaves
    (L, n_pages, page_size, Hkv, D) (moe: ``blocks_dense`` and
    ``blocks_moe``, MLA's ``ckv`` and ``krope`` leaves), a JAX contiguous
    cache of the same keys with leaves (L, B, S, ...), a JAX hybrid
    cache (``mamba_units``, ``shared_attn``, ``mamba_tail``), an xLSTM
    one (``mlstm_units``, ``slstm_units``) or whisper's ``{"dec": {"k",
    "v", "xk", "xv"}}``; bit for bit, bf16 included."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


# leaves the reference keeps in fp32 whatever the param dtype
# (repro/models/ssm.py::init_mamba2, repro/models/moe.py::init_moe, the
# xLSTM gate biases of repro/models/xlstm.py)
FP32_LEAVES = ("A_log", "D", "dt_bias", "router", "b_if", "b_gates")


def _attn_shapes(cfg: ModelConfig, lead=()) -> dict:
    """Path under a block -> shape of its attention leaves: GQA's w_q and
    w_k, or every MLA projection and norm."""
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla is None:
        hd = cfg.resolved_head_dim
        return {("attn", "w_q"): (*lead, d, H * hd),
                ("attn", "w_k"): (*lead, d, cfg.n_kv_heads * hd)}
    m = cfg.mla
    return {("attn", k): (*lead, *v) for k, v in {
        "w_dq": (d, m.q_lora_rank),
        "w_uq": (m.q_lora_rank, H * (m.qk_nope_head_dim
                                     + m.qk_rope_head_dim)),
        "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
        "w_uk": (m.kv_lora_rank, H * m.qk_nope_head_dim),
        "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
        "w_o": (H * m.v_head_dim, d)}.items()} | {
        ("attn", "q_norm", "scale"): (*lead, m.q_lora_rank),
        ("attn", "kv_norm", "scale"): (*lead, m.kv_lora_rank)}


def _moe_shapes(cfg: ModelConfig) -> dict:
    """Tree path -> shape of a moe config's stacks and MTP block: the
    dense-MLP layers, the router and stacked experts (and the shared
    expert) of the MoE layers, MLA or GQA attention in both."""
    m, d = cfg.moe, cfg.d_model
    want = {}
    stacks = [("blocks_moe", cfg.n_layers - m.n_dense_layers)]
    if m.n_dense_layers:
        stacks.append(("blocks_dense", m.n_dense_layers))
        want[("blocks_dense", "mlp", "w_gate")] = (m.n_dense_layers, d,
                                                   m.dense_d_ff)
    for name, n in stacks:
        want.update({(name, *k): v for k, v in
                     _attn_shapes(cfg, (n,)).items()})
    n = stacks[0][1]
    E, f = m.n_experts, m.d_expert
    want.update({("blocks_moe", "moe", "router"): (n, d, E),
                 ("blocks_moe", "moe", "w_gate"): (n, E, d, f),
                 ("blocks_moe", "moe", "w_up"): (n, E, d, f),
                 ("blocks_moe", "moe", "w_down"): (n, E, f, d)})
    if m.n_shared_experts:
        want[("blocks_moe", "moe", "shared", "w_gate")] = (
            n, d, m.n_shared_experts * m.d_shared_expert)
    if cfg.use_mtp:
        ff = m.dense_d_ff or cfg.d_ff
        want.update({("mtp", "proj"): (2 * d, d),
                     ("mtp", "block", "mlp", "w_gate"): (d, ff)})
        want.update({("mtp", "block", *k): v
                     for k, v in _attn_shapes(cfg).items()})
    return want


def _xlstm_shapes(cfg: ModelConfig) -> dict:
    """Tree path -> shape of every leaf of an xLSTM (ssm) tree: the
    mLSTM stack with leading (units, slstm_every - 1) axes, the sLSTM
    stack with a leading (units,) axis, the embedding, final norm and
    head."""
    xl, d = cfg.xlstm, cfg.d_model
    units, per = cfg.n_layers // xl.slstm_every, xl.slstm_every - 1
    d_inner = int(xl.proj_factor_mlstm * d)
    nh = cfg.n_heads
    dh, dhs = d_inner // nh, d // nh
    d_ff = int(xl.proj_factor_slstm * d)
    mlstm = {("norm", "scale"): (d,), ("w_up",): (d, 2 * d_inner),
             ("conv_w",): (xl.d_conv, d_inner), ("conv_b",): (d_inner,),
             ("w_q",): (nh, dh, dh), ("w_k",): (nh, dh, dh),
             ("w_v",): (nh, dh, dh), ("w_if",): (d_inner, 2 * nh),
             ("b_if",): (2 * nh,), ("skip",): (d_inner,),
             ("gn", "scale"): (dh,), ("w_down",): (d_inner, d)}
    slstm = {("norm", "scale"): (d,), ("conv_w",): (xl.d_conv, d),
             ("conv_b",): (d,), ("w_gates",): (d, 4 * d),
             ("r_gates",): (4, nh, dhs, dhs), ("b_gates",): (4 * d,),
             ("gn", "scale"): (dhs,), ("up", "w_gate"): (d, d_ff),
             ("up", "w_up"): (d, d_ff), ("up", "w_down"): (d_ff, d)}
    want = {("final_norm", "scale"): (d,)}
    if not cfg.tie_embeddings:
        want[("lm_head",)] = (d, cfg.vocab_size)
    want.update({("mlstm_units", *k): (units, per, *v)
                 for k, v in mlstm.items()})
    want.update({("slstm_units", *k): (units, *v) for k, v in slstm.items()})
    return want


def _audio_shapes(cfg: ModelConfig) -> dict:
    """Tree path -> shape of the leaves that pin whisper's widths: both
    stacks' LayerNorms, attention (with its biases) and GELU MLP, the
    decoder's cross-attention, ``enc_ln``, the final LayerNorm, the
    untied head, and ``dec_pos`` (None: its length is the max_seq the
    params were made for)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.n_heads * cfg.resolved_head_dim, \
        cfg.n_kv_heads * cfg.resolved_head_dim
    block = {("ln1", "scale"): (d,), ("ln1", "bias"): (d,),
             ("attn", "w_q"): (d, q), ("attn", "w_k"): (d, kv),
             ("attn", "w_v"): (d, kv), ("attn", "w_o"): (q, d),
             ("attn", "b_q"): (q,), ("attn", "b_k"): (kv,),
             ("ln2", "scale"): (d,), ("ln2", "bias"): (d,),
             ("mlp", "w_up"): (d, ff), ("mlp", "b_up"): (ff,),
             ("mlp", "w_down"): (ff, d), ("mlp", "b_down"): (d,)}
    cross = {("ln_x", "bias"): (d,), ("xattn", "w_q"): (d, q),
             ("xattn", "w_k"): (d, kv), ("xattn", "b_v"): (kv,),
             ("xattn", "w_o"): (q, d)}
    want = {("enc_ln", "scale"): (d,), ("enc_ln", "bias"): (d,),
            ("final_norm", "bias"): (d,), ("dec_pos",): (None, d)}
    if not cfg.tie_embeddings:
        want[("lm_head",)] = (d, V)
    for name, n, leaves in (("enc_blocks", cfg.n_encoder_layers, block),
                            ("dec_blocks", cfg.n_layers, block | cross)):
        want.update({(name, *k): (n, *v) for k, v in leaves.items()})
    return want


def _expected_shapes(cfg: ModelConfig) -> dict:
    """Tree path -> shape of the leaves that pin a config's widths (None
    for an axis the config does not fix)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    want = {("embed",): (cfg.vocab_size, d)}
    # the MLP kind: a GELU tree has w_up/b_up, a SwiGLU tree w_gate
    mlp = ({"w_up": (d, cfg.d_ff), "b_up": (cfg.d_ff,)}
           if cfg.mlp_type == "gelu" else {"w_gate": (d, cfg.d_ff)})
    if cfg.family == "moe":
        want.update(_moe_shapes(cfg))
        return want
    if cfg.family == "ssm":
        want.update(_xlstm_shapes(cfg))
        return want
    if cfg.family == "audio":
        want.update(_audio_shapes(cfg))
        return want
    if cfg.family in ("dense", "vlm"):
        L = cfg.n_layers
        want.update({
            ("blocks", "attn", "w_q"): (L, d, cfg.n_heads * hd),
            ("blocks", "attn", "w_k"): (L, d, cfg.n_kv_heads * hd),
            ("blocks", "mlp", "w_down"): (L, cfg.d_ff, d)})
        want.update({("blocks", "mlp", k): (L, *v) for k, v in mlp.items()})
        if cfg.qkv_bias:
            want[("blocks", "attn", "b_k")] = (L, cfg.n_kv_heads * hd)
        if not cfg.tie_embeddings:
            want[("lm_head",)] = (d, cfg.vocab_size)
        return want
    s = cfg.ssm
    d_inner = s.expand * d
    nh = d_inner // s.head_dim
    proj = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
    k = cfg.shared_attn_every
    units, tail = divmod(cfg.n_layers, k)
    want.update({
        ("mamba_units", "in_proj"): (units, k, d, proj),
        ("mamba_units", "out_proj"): (units, k, d_inner, d),
        ("mamba_units", "A_log"): (units, k, nh),
        ("shared_attn", "ln1", "scale"): (2 * d,),
        ("shared_attn", "attn", "w_q"): (2 * d, cfg.n_heads * hd),
        ("shared_attn", "attn", "w_k"): (2 * d, cfg.n_kv_heads * hd),
        ("shared_attn", "attn", "w_o"): (cfg.n_heads * hd, d),
        ("shared_attn", "mlp", "w_down"): (cfg.d_ff, d),
        **{("shared_attn", "mlp", k): v for k, v in mlp.items()},
        ("shared_adapters",): (units, d, d)})
    if tail:
        want[("mamba_tail", "in_proj")] = (tail, d, proj)
    return want


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """A JAX params tree (numpy leaves) as the port's params on
    ``device``, checked against ``cfg``: the stacked layer (dense, moe)
    or unit/tail (hybrid, ssm) axes and the widths must match (a moe
    tree: ``blocks_dense``, ``blocks_moe`` with router, stacked experts
    and shared expert, MLA's projections, ``mtp`` exactly when the config
    has it; an ssm tree: exactly the leaves of ``_xlstm_shapes``, each
    of its shape; an audio tree: ``_audio_shapes``, the two stacks, the
    cross-attention, the LayerNorms and ``dec_pos`` of any length), and
    every leaf must be in the param dtype, except
    ``A_log``, ``D``, ``dt_bias``, the MoE ``router`` and the xLSTM gate
    biases ``b_if`` and ``b_gates``, which are fp32 in any param
    dtype."""
    p = tree_from_numpy(tree, device)
    if ("mtp" in p) != cfg.use_mtp:
        state = "present" if "mtp" in p else "missing"
        raise ValueError(f"params/mtp: {state} but {cfg.name} has "
                         f"use_mtp={cfg.use_mtp}")
    for path, shape in _expected_shapes(cfg).items():
        leaf = p
        for k in path:
            if not isinstance(leaf, dict) or k not in leaf:
                raise ValueError(f"params/{'/'.join(path)}: missing for "
                                 f"{cfg.name} (mlp_type {cfg.mlp_type!r})")
            leaf = leaf[k]
        if len(leaf.shape) != len(shape) or any(
                w is not None and g != w for g, w in zip(leaf.shape, shape)):
            raise ValueError(f"params/{'/'.join(path)}: shape "
                             f"{tuple(leaf.shape)} != {shape} for {cfg.name}")
    if cfg.family == "ssm":
        extra = sorted("/".join(path) for path, _ in _leaves(p)
                       if path not in _expected_shapes(cfg))
        if extra:
            raise ValueError(f"params: {extra} are not {cfg.name}'s")
    for path, leaf in _leaves(p):
        want = (torch.float32 if path[-1] in FP32_LEAVES
                else dtype_of(cfg.param_dtype))
        if leaf.dtype != want:
            raise ValueError(f"params/{'/'.join(path)}: dtype {leaf.dtype} "
                             f"!= {want}")
    return p


def _classifier_shapes(cfg) -> dict:
    """Tree path -> shape of every leaf of a ``ClassifierConfig``'s
    params (``core/classifier.py::init_classifier``)."""
    d, ff = cfg.d_model, cfg.d_model * 4
    want = {("embed",): (cfg.patch * cfg.patch * 3, d),
            ("head",): (d, cfg.n_classes)}
    for i in range(cfg.n_layers):
        want.update({(f"mlp{i}", "w_gate"): (d, ff),
                     (f"mlp{i}", "w_up"): (d, ff),
                     (f"mlp{i}", "w_down"): (ff, d),
                     (f"ln{i}", "scale"): (d,)})
    return want


def classifier_params_from_numpy(tree: dict, cfg, device="cuda") -> dict:
    """A JAX tile-classifier params tree (numpy leaves) as the port's
    params on ``device``, checked against the ``ClassifierConfig``
    ``cfg``: the same leaves, each of the config's shape, in fp32."""
    p = tree_from_numpy(tree, device)
    got = {path: tuple(leaf.shape) for path, leaf in _leaves(p)}
    want = _classifier_shapes(cfg)
    if got != want:
        bad = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"classifier params do not match {cfg}: {bad}")
    for path, leaf in _leaves(p):
        if leaf.dtype != torch.float32:
            raise ValueError(f"params/{'/'.join(path)}: dtype {leaf.dtype} "
                             "!= torch.float32")
    return p
