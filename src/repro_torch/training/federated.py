"""Federated learning across satellite nodes (paper §3.4): the twin of
the JAX package's ``training/federated.py``.

Each satellite trains on its LOCAL data shard (privacy: raw data never
leaves the satellite, only parameters do) and uploads weights when a
ground contact occurs.  The ground aggregates with staleness-discounted
FedAvg (satellites see the ground at different times; FedSpace-style
scheduling [paper ref 16]), over the contact schedule of
``core.link.ContactSchedule``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.link import ContactSchedule
from repro_torch.training import optim
from repro_torch.training.loop import TrainState, init_state, train
from repro_torch.tree import tree_map

F32 = torch.float32


@dataclass(frozen=True)
class FedConfig:
    n_satellites: int = 3
    local_steps: int = 10
    rounds: int = 3
    staleness_half_life_s: float = 5_400.0     # ~1 orbit
    seed: int = 0


def fedavg(global_params, sat_params: List[dict], weights: List[float]):
    """Staleness-weighted FedAvg; residual weight stays on the global.
    Sums in fp32, in the reference's order, cast back to each leaf's
    type."""
    wsum = sum(weights)
    if wsum <= 0:
        return global_params
    norm = [w / max(wsum, 1.0) for w in weights]
    rest = max(0.0, 1.0 - sum(norm))
    acc = tree_map(lambda x: x.to(F32) * rest, global_params)
    for p, w in zip(sat_params, norm):
        acc = tree_map(lambda a, x: a + x.to(F32) * w, acc, p)
    return tree_map(lambda x, ref: x.to(ref.dtype), acc, global_params)


def run_federated(cfg: ModelConfig, fed: FedConfig, make_data, *,
                  opt_cfg: optim.OptimConfig = optim.OptimConfig(lr=1e-3),
                  device="cuda") -> dict:
    """make_data(sat_idx) -> iterable of batches (the satellite's shard).
    Returns {"global_params", "rounds": [...telemetry...]}."""
    global_params = init_state(cfg, opt_cfg, seed=fed.seed,
                               device=device).params
    schedules = [ContactSchedule(seed=i) for i in range(fed.n_satellites)]
    telemetry = []
    t = 0.0
    for rnd in range(fed.rounds):
        sat_params, weights, losses = [], [], []
        for i in range(fed.n_satellites):
            st = TrainState(params=global_params,
                            opt_state=optim.adamw_init(global_params,
                                                       opt_cfg))
            st = train(cfg, st, make_data(i), opt_cfg,
                       steps=fed.local_steps, log_every=fed.local_steps)
            # contact gating: weight by staleness at the next uplink
            win = schedules[i].next_window(t)
            delay = (win[0] - t) if win else fed.staleness_half_life_s * 4
            w = 0.5 ** (delay / fed.staleness_half_life_s)
            sat_params.append(st.params)
            weights.append(w)
            losses.append(st.history[-1]["loss"] if st.history else None)
        global_params = fedavg(global_params, sat_params, weights)
        t += 5_400.0                                  # one orbit per round
        telemetry.append({"round": rnd, "weights": weights,
                          "local_losses": losses})
    return {"global_params": global_params, "rounds": telemetry}
