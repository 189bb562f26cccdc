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
    (L, n_pages, page_size, Hkv, D), or a JAX contiguous cache of the
    same keys with leaves (L, B, S, Hkv, D); bit for bit, bf16 included."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    return tensor_from_numpy(tree, dev)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """A JAX params tree (numpy leaves) as the port's params on
    ``device``, checked against ``cfg``: the stacked layer axis, the
    attention widths and the param dtype must match."""
    p = tree_from_numpy(tree, device)
    hd = cfg.resolved_head_dim
    want = {
        ("embed",): (cfg.vocab_size, cfg.d_model),
        ("blocks", "attn", "w_q"): (cfg.n_layers, cfg.d_model,
                                    cfg.n_heads * hd),
        ("blocks", "attn", "w_k"): (cfg.n_layers, cfg.d_model,
                                    cfg.n_kv_heads * hd),
        ("blocks", "mlp", "w_down"): (cfg.n_layers, cfg.d_ff, cfg.d_model),
    }
    for path, shape in want.items():
        leaf = p
        for k in path:
            leaf = leaf[k]
        if tuple(leaf.shape) != shape:
            raise ValueError(f"params/{'/'.join(path)}: shape "
                             f"{tuple(leaf.shape)} != {shape} for {cfg.name}")
        if leaf.dtype != dtype_of(cfg.param_dtype):
            raise ValueError(f"params/{'/'.join(path)}: dtype {leaf.dtype} "
                             f"!= {cfg.param_dtype}")
    return p
