"""Single-host training loop: the twin of the JAX package's
``training/loop.py``.  One step is ``loss_fn``'s backward and one
``adamw_update`` (``launch.steps.make_train_step``); batches are the
data stream's numpy dicts, moved to the params' device."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from repro_torch.config import ModelConfig
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
               device="cuda") -> TrainState:
    """Params from ``T.init_params`` (a seeded ``torch.Generator``, not
    the JAX package's numbers: parity tests bridge those in; ``max_seq``
    sizes whisper's ``dec_pos``) and zero AdamW moments, on ``device``."""
    params = T.init_params(cfg, seed=seed, device=device, max_seq=max_seq)
    return TrainState(params=params,
                      opt_state=optim.adamw_init(params, opt_cfg))


def train(cfg: ModelConfig, state: TrainState, data: Iterable[dict],
          opt_cfg: optim.OptimConfig, *, steps: int,
          log_every: int = 20,
          callback: Optional[Callable] = None) -> TrainState:
    """``steps`` steps on batches from ``data``.  Every ``log_every``-th
    step and the first append a row to ``state.history`` (the step's
    metrics as floats, ``step`` and ``wall_s``) and pass it to
    ``callback``."""
    step_fn = make_train_step(cfg, opt_cfg)
    dev = tree_leaves(state.params)[0].device
    it = iter(data)
    t0 = time.time()
    for _ in range(steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(it).items()}
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
