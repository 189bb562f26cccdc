"""Request batching for the two-tier serving deployment (a copy of the
JAX package's ``serving.batching``: ``poisson_trace`` makes the same
seeded draws, draw for draw).

Two admission disciplines feed the engines in ``serving.engine``:

  * Fixed-slot (seed behavior): requests queue up, get padded to a
    common prompt length and dispatched as one batch — the batch must
    drain before the next one starts.
  * Continuous (``ContinuousEngine``): the queue is drained one request
    at a time into whichever KV-cache slot frees up, so arrivals join
    mid-flight.  ``RequestQueue`` stays the single admission point; a
    bounded ``capacity`` gives the ground tier backpressure under the
    heavy-traffic regime instead of unbounded memory growth.  Under the
    paged KV layout admission is additionally gated on the page pool:
    ``Request.pages_needed`` is the worst-case lifetime page count the
    engine reserves up front.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

_ids = itertools.count()


def ensure_rid_floor(n: int) -> None:
    """Advance the global rid counter to at least ``n``.  A checkpoint
    restore rebuilds Requests with their ORIGINAL rids; without bumping
    the counter past them, the next fresh Request (e.g. an escalation
    ``clone``) could collide with a restored rid and cross-wire two
    sequences' results."""
    global _ids
    nxt = next(_ids)
    _ids = itertools.count(max(nxt, n))


class QueueFull(RuntimeError):
    """Raised when a bounded RequestQueue rejects a submission."""


@dataclass
class Request:
    prompt: np.ndarray                    # (S,) int32
    max_new: int = 16
    rid: int = field(default_factory=lambda: next(_ids))
    arrival_t: float = 0.0                # engine-clock steps
    priority: int = 0                     # higher preempts lower (scheduler)
    prefill_pos: int = 0                  # prompt tokens already chunked
    #                                       into the KV cache (the unified
    #                                       token-budget step admits prompts
    #                                       chunk-by-chunk; preempt/resume
    #                                       continues from here, and a
    #                                       redo-from-prefill resets it)
    draft_toks: Optional[np.ndarray] = None
    #                                       (n,) int32 speculative draft of
    #                                       the greedy continuation (e.g. the
    #                                       satellite tier's answer riding a
    #                                       ground escalation): the engine
    #                                       verifies it in chunked passes
    #                                       instead of decoding token-by-token

    def pages_needed(self, page_size: int) -> int:
        """Worst-case KV pages over the request's lifetime: the cache
        holds positions [0, prompt + max_new - 1) (the final emitted
        token is never written back)."""
        n_positions = len(self.prompt) + self.max_new - 1
        return -(-n_positions // page_size)

    def clone(self) -> "Request":
        """Fresh-rid copy for replaying the same workload through
        another engine (benchmark/test A-B comparisons); prefill
        progress and any attached draft stream do not carry over —
        drafts are delivery metadata the sender re-attaches."""
        return Request(prompt=self.prompt.copy(), max_new=self.max_new,
                       arrival_t=self.arrival_t, priority=self.priority)


@dataclass
class Batch:
    requests: List[Request]
    tokens: np.ndarray                    # (B, S_max) left-padded
    lengths: np.ndarray                   # (B,)


class RequestQueue:
    def __init__(self, max_batch: int = 8, pad_id: int = 0,
                 capacity: Optional[int] = None):
        self.max_batch = max_batch
        self.pad_id = pad_id
        self.capacity = capacity
        self._q: Deque[Request] = collections.deque()

    def submit(self, req: Request) -> int:
        if self.capacity is not None and len(self._q) >= self.capacity:
            raise QueueFull(
                f"queue at capacity ({self.capacity}); request {req.rid} "
                "rejected — retry after the engine drains")
        self._q.append(req)
        return req.rid

    def __len__(self) -> int:
        return len(self._q)

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pop(self) -> Request:
        return self._q.popleft()

    def arrived(self, now: float) -> List[Request]:
        """Queued requests whose arrival time has passed, FIFO order."""
        return [r for r in self._q if r.arrival_t <= now]

    def items(self) -> List[Request]:
        """The whole backlog in FIFO order (checkpoint serialization),
        including requests whose arrival time has not passed yet."""
        return list(self._q)

    def take(self, req: Request) -> Request:
        """Remove ``req`` (matched by identity: dataclass equality would
        compare the numpy prompts) from anywhere in the queue."""
        for i, r in enumerate(self._q):
            if r is req:
                del self._q[i]
                return req
        raise ValueError(f"request {req.rid} not queued")

    def requeue_front(self, req: Request) -> None:
        """Put an already-admitted request back at the head (abort /
        redo-from-prefill — any partial-prefill progress is discarded
        with the KV that held it); deliberately exempt from the capacity
        check — the request's slot was already granted once."""
        req.prefill_pos = 0
        self._q.appendleft(req)

    def next_batch(self) -> Optional[Batch]:
        if not self._q:
            return None
        reqs = [self._q.popleft()
                for _ in range(min(self.max_batch, len(self._q)))]
        S = max(len(r.prompt) for r in reqs)
        toks = np.full((len(reqs), S), self.pad_id, np.int32)
        lens = np.empty((len(reqs),), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt   # left padding
            lens[i] = len(r.prompt)
        return Batch(requests=reqs, tokens=toks, lengths=lens)


def poisson_trace(n_requests: int, *, rate: float = 0.5,
                  prompt_lens=(4, 16), max_new=(2, 24),
                  vocab_size: int = 256, seed: int = 0,
                  priorities=(0, 0)) -> List[Request]:
    """A Poisson arrival trace with heterogeneous prompt lengths and
    decode budgets — the workload continuous batching is built for.

    rate: mean arrivals per engine decode step; inter-arrival gaps are
    exponential.  prompt_lens / max_new / priorities: inclusive
    (lo, hi) ranges sampled uniformly (priorities defaults to all-0 —
    FIFO, no preemption pressure).  Returns requests sorted by
    arrival_t.
    """
    rng = np.random.default_rng(seed)
    sample_prio = tuple(priorities) != (0, 0)
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        S = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        out.append(Request(
            prompt=rng.integers(1, vocab_size, S).astype(np.int32),
            max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
            arrival_t=t,
            # drawn only when asked: the default trace's RNG stream (and
            # therefore every seeded benchmark workload) stays identical
            priority=(int(rng.integers(priorities[0], priorities[1] + 1))
                      if sample_prio else 0)))
    return out
