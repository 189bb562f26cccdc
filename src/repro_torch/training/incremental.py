"""Incremental training (paper §3.4): the twin of the JAX package's
``training/incremental.py``.  The deployed onboard model drifts as the
data distribution changes (weather, season); satellites collect new
data, the cloud fine-tunes, and the satellite pulls the refreshed
weights at the next contact."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import ModelConfig
from repro_torch.training import optim
from repro_torch.training.loop import TrainState, train


@dataclass(frozen=True)
class IncrementalConfig:
    finetune_steps: int = 30
    lr: float = 3e-4


def incremental_update(cfg: ModelConfig, state: TrainState, new_data, *,
                       inc: IncrementalConfig = IncrementalConfig()):
    """Fine-tune the current weights on the drifted distribution."""
    opt_cfg = optim.OptimConfig(lr=inc.lr, warmup_steps=5,
                                total_steps=inc.finetune_steps)
    state.opt_state = optim.adamw_init(state.params, opt_cfg)
    return train(cfg, state, new_data, opt_cfg, steps=inc.finetune_steps,
                 log_every=max(inc.finetune_steps // 3, 1))
