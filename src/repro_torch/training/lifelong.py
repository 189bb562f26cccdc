"""Lifelong learning (paper §3.4), the twin of the JAX package's
``training/lifelong.py``: satellites face data drift and
catastrophic forgetting; a cloud-side KNOWLEDGE LIBRARY stores per-task
knowledge, and onboard updates combine incremental training with
rehearsal over library samples so earlier scenarios are not forgotten.

Implementation: the library keeps, per task/scenario, (a) a compact
replay buffer of batches and (b) the post-task parameter snapshot.
``lifelong_update`` fine-tunes on the new scenario while mixing replayed
batches from every known scenario (experience rehearsal — the simplest
robust continual-learning baseline), and registers the new scenario in
the library afterwards.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch.config import ModelConfig
from repro_torch.training import optim
from repro_torch.training.loop import TrainState, train


@dataclass
class KnowledgeLibrary:
    """Cloud-side per-scenario knowledge store."""
    replay: Dict[str, List[dict]] = field(default_factory=dict)
    snapshots: Dict[str, dict] = field(default_factory=dict)
    max_batches_per_task: int = 8

    def register(self, task: str, batches: List[dict],
                 params: Optional[dict] = None) -> None:
        self.replay[task] = list(batches)[: self.max_batches_per_task]
        if params is not None:
            self.snapshots[task] = params

    def tasks(self) -> List[str]:
        return list(self.replay)

    def rehearsal_iter(self, seed: int = 0) -> Iterator[dict]:
        """Round-robin over stored tasks' replay batches, forever."""
        rng = np.random.default_rng(seed)
        tasks = self.tasks()
        while True:
            for t in tasks:
                buf = self.replay[t]
                yield buf[int(rng.integers(0, len(buf)))]


@dataclass(frozen=True)
class LifelongConfig:
    steps_per_task: int = 20
    rehearsal_ratio: float = 0.5       # fraction of steps from the library
    lr: float = 1e-3


def _mixed_stream(new_data: Iterator[dict], library: KnowledgeLibrary,
                  ratio: float, seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    rehearsal = library.rehearsal_iter(seed) if library.tasks() else None
    while True:
        if rehearsal is not None and rng.random() < ratio:
            yield next(rehearsal)
        else:
            yield next(new_data)


def lifelong_update(cfg: ModelConfig, state: TrainState, task: str,
                    new_data: Iterable[dict], library: KnowledgeLibrary,
                    *, ll: LifelongConfig = LifelongConfig()) -> TrainState:
    """Adapt to a new scenario with rehearsal, then register it."""
    it = iter(new_data)
    # reserve some fresh batches for the replay buffer
    reserve = [next(it) for _ in range(library.max_batches_per_task)]
    stream = _mixed_stream(itertools.chain(reserve, it), library,
                           ll.rehearsal_ratio)
    opt_cfg = optim.OptimConfig(lr=ll.lr, warmup_steps=2,
                                total_steps=ll.steps_per_task)
    state.opt_state = optim.adamw_init(state.params, opt_cfg)
    state = train(cfg, state, stream, opt_cfg, steps=ll.steps_per_task,
                  log_every=max(ll.steps_per_task // 2, 1))
    library.register(task, reserve, state.params)
    return state
