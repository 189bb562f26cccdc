"""Training loop: the twin of the JAX package's ``training/loop.py``.
One step is ``loss_fn``'s backward and one ``adamw_update``
(``launch.steps.make_train_step``); batches are the data stream's numpy
dicts, moved to the params' device.  On a ``(data, model)`` mesh
(``launch.mesh.make_mesh``) every rank runs the loop on its slices of
the params and moments, draws the same global batch from the stream
and keeps its rows (``launch.sharding.shard_batch``)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.training import optim
from repro_torch.tree import tree_leaves


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0
    history: list = field(default_factory=list)


def init_state(cfg: ModelConfig, opt_cfg: optim.OptimConfig, *,
               seed: int = 0, max_seq: int = 4096,
               device="cuda", mesh=None, logical_map=None) -> TrainState:
    """Params from ``T.init_params`` (a seeded ``torch.Generator``, not
    the JAX package's numbers: parity tests bridge those in; ``max_seq``
    sizes whisper's ``dec_pos``) and zero AdamW moments, on ``device``.
    With a ``mesh``, this rank's slices of them (``logical_map`` a
    training preset's, None: ``baseline``)."""
    params = T.init_params(cfg, seed=seed, device=device, max_seq=max_seq)
    if mesh is not None:
        params = SH.shard_params(cfg, params, mesh,
                                 SH.check_train(cfg, logical_map))
    return TrainState(params=params,
                      opt_state=optim.adamw_init(params, opt_cfg))


def train(cfg: ModelConfig, state: TrainState, data: Iterable[dict],
          opt_cfg: optim.OptimConfig, *, steps: int,
          log_every: int = 20,
          callback: Optional[Callable] = None, mesh=None,
          logical_map=None) -> TrainState:
    """``steps`` steps on batches from ``data``.  Every ``log_every``-th
    step and the first append a row to ``state.history`` (the step's
    metrics as floats, ``step`` and ``wall_s``) and pass it to
    ``callback``.  With a ``mesh`` (every rank calls this, on the same
    ``data``), ``state`` holds this rank's slices (``init_state(...,
    mesh=)``) and each step takes this rank's rows of the batch; the
    rows logged are the whole batch's metrics."""
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                              logical_map=logical_map)
    lmap = None if mesh is None else SH.check_train(cfg, logical_map)
    dev = tree_leaves(state.params)[0].device
    it = iter(data)
    t0 = time.time()
    for _ in range(steps):
        batch = next(it)
        if mesh is not None:
            batch = SH.shard_batch(batch, mesh, lmap)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        state.params, state.opt_state, m = step_fn(
            state.params, state.opt_state, batch)
        state.step += 1
        if state.step % log_every == 0 or state.step == 1:
            row = {k: float(v) for k, v in m.items()}
            row["step"] = state.step
            row["wall_s"] = round(time.time() - t0, 2)
            state.history.append(row)
            if callback:
                callback(row)
    return state
