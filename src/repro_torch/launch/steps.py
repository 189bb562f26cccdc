"""Step functions of the port: the twin of the JAX package's
``launch/steps.py``.  ``make_train_step`` is what ``training.loop.train``
and ``launch/train.py`` run.  The reference's prefill and serve step
makers are called only by its dry-run, which is not ported; the engines
here call ``transformer.prefill`` and ``transformer.decode_step``."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.training import optim
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptimConfig, *,
                    mode: str = "flash", remat: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``loss_fn``'s gradient with respect to every param leaf
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives it), then one ``adamw_update``.  The inputs are
    not written; metrics are ``loss_fn``'s and the optimizer's, 0-d
    tensors."""
    def train_step(params, opt_state, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(p)
        with torch.enable_grad():
            total, metrics = T.loss_fn(p, cfg, batch, mode=mode, remat=remat)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = tree_unflatten(p, [torch.zeros_like(x) if g is None else g
                                   for x, g in zip(leaves, grads)])
        params, opt_state, om = optim.adamw_update(params, grads, opt_state,
                                                   opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, {**metrics, **om}
    return train_step

