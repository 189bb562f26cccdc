"""Parameter counting from the real init's shapes: the twin of the JAX
package's ``models/counting.py``.  ``transformer.param_shapes`` runs
``init_params`` on the meta device (no allocation, no draw), so the
count always follows the model, with the reference's analytic
correction for MoE active-parameter counts (MODEL_FLOPS = 6 * N_active
* D)."""
from __future__ import annotations

import functools

from repro_torch.config import ModelConfig
from repro_torch.tree import tree_leaves


@functools.lru_cache(maxsize=64)
def _total(cfg: ModelConfig, max_seq: int) -> int:
    from repro_torch.models.transformer import param_shapes
    return sum(t.numel() for t in tree_leaves(param_shapes(cfg, max_seq)))


def count_params(cfg: ModelConfig, active_only: bool = False,
                 max_seq: int = 4096) -> int:
    """The params of ``cfg`` (``max_seq`` sizes whisper's ``dec_pos``);
    with ``active_only``, a MoE config's routed experts count only the
    ``experts_per_token`` a token uses."""
    total = _total(cfg, max_seq)
    if active_only and cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = cfg.n_layers - m.n_dense_layers
        per_expert = 3 * cfg.d_model * m.d_expert
        total -= (n_moe_layers * (m.n_experts - m.experts_per_token)
                  * per_expert)
    return total
