"""Synthetic token pipeline: a copy of the JAX package's ``data/tokens.py``
(numpy only), so the port draws the same batches draw for draw.

A deterministic, learnable pseudo-language.

Sequences are generated from a fixed random 2nd-order Markov chain with
Zipfian marginals plus periodic copy spans; small models reduce loss
quickly (used by examples/train_100m.py and the training tests), and
the stream is shardable by (host, step) with no state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int = 512
    seq_len: int = 256
    batch_size: int = 8
    seed: int = 0
    branching: int = 4              # candidate successors per bigram


class TokenStream:
    def __init__(self, cfg: TokenStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, K = cfg.vocab_size, cfg.branching
        # per (prev token) a small successor table with Zipf weights
        self._succ = rng.integers(0, V, size=(V, K))
        w = 1.0 / np.arange(1, K + 1)
        self._w = w / w.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.batch_size, cfg.seq_len
        out = np.empty((B, S), np.int64)
        tok = rng.integers(0, cfg.vocab_size, size=B)
        for t in range(S):
            out[:, t] = tok
            pick = rng.choice(cfg.branching, size=B, p=self._w)
            tok = self._succ[tok, pick]
        # periodic copy spans (position 3/4 copies the first quarter)
        q = S // 4
        if q > 1:
            out[:, 3 * q:3 * q + q // 2] = out[:, :q // 2]
        return {"tokens": out.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
