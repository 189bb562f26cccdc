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
    (L, n_pages, page_size, Hkv, D), a JAX contiguous cache of the same
    keys with leaves (L, B, S, Hkv, D), or a JAX hybrid cache
    (``mamba_units``, ``shared_attn``, ``mamba_tail``); bit for bit, bf16
    included."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


# leaves the reference keeps in fp32 whatever the param dtype
# (repro/models/ssm.py::init_mamba2)
FP32_LEAVES = ("A_log", "D", "dt_bias")


def _expected_shapes(cfg: ModelConfig) -> dict:
    """Tree path -> shape of the leaves that pin a config's widths."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    want = {("embed",): (cfg.vocab_size, d)}
    # the MLP kind: a GELU tree has w_up/b_up, a SwiGLU tree w_gate
    mlp = ({"w_up": (d, cfg.d_ff), "b_up": (cfg.d_ff,)}
           if cfg.mlp_type == "gelu" else {"w_gate": (d, cfg.d_ff)})
    if cfg.family == "dense":
        L = cfg.n_layers
        want.update({
            ("blocks", "attn", "w_q"): (L, d, cfg.n_heads * hd),
            ("blocks", "attn", "w_k"): (L, d, cfg.n_kv_heads * hd),
            ("blocks", "mlp", "w_down"): (L, cfg.d_ff, d)})
        want.update({("blocks", "mlp", k): (L, *v) for k, v in mlp.items()})
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
    ``device``, checked against ``cfg``: the stacked layer (dense) or
    unit/tail (hybrid) axes and the widths must match, and every leaf
    must be in the param dtype, except ``A_log``, ``D`` and ``dt_bias``,
    which are fp32 in any param dtype."""
    p = tree_from_numpy(tree, device)
    for path, shape in _expected_shapes(cfg).items():
        leaf = p
        for k in path:
            if not isinstance(leaf, dict) or k not in leaf:
                raise ValueError(f"params/{'/'.join(path)}: missing for "
                                 f"{cfg.name} (mlp_type {cfg.mlp_type!r})")
            leaf = leaf[k]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"params/{'/'.join(path)}: shape "
                             f"{tuple(leaf.shape)} != {shape} for {cfg.name}")
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
