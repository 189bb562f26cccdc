"""Deterministic fault injection for the space-ground replay: a copy of
the JAX package's ``core/faults.py`` (numpy only), so the same plan
draws the same faults, draw for draw, in both packages.

The paper's premise is that the downlink is scarce AND unreliable (its
section II cites a mission that lost 80% of its packets), and a
cloud-native satellite must also survive payload reboots.  This module
turns those failure modes into a seeded, replayable plan:

  * per-frame packet erasure and bit-flip corruption on the transmit
    lane (``core.link.TransmitLane`` in framed mode draws one fate per
    frame transmission);
  * early-LOS truncation of contact windows;
  * spill-store record corruption (``serving.paging.DeltaSpillStore``
    must DETECT it, never graft it);
  * a scheduled satellite crash at engine tick ``t`` (the serving state
    restores from its last checkpoint and resumes token-exactly).

Everything is driven by ONE numpy PCG64 generator seeded from the plan.
The injector's counters are the ground truth a run is checked against
(every injected corruption must be detected downstream); they round
trip through ``state()``/``load_state()`` so a crash-rollback restores
them consistently with the subsystems they audit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultPlan:
    """A seeded description of what goes wrong, and when."""
    seed: int = 0
    # -- transmit lane: one fate drawn per frame transmission ---------------
    frame_loss_rate: float = 0.0       # P(frame erased in transit)
    frame_corrupt_rate: float = 0.0    # P(frame arrives bit-flipped)
    # -- contact windows ----------------------------------------------------
    truncate_every: int = 0            # every k-th pass ends early (0: never)
    truncate_frac: float = 0.5         # fraction of the pass that survives
    # -- spill store --------------------------------------------------------
    spill_corrupt_every: int = 0       # every k-th store merge lands with a
    #                                    flipped bit in its host record
    # -- crash --------------------------------------------------------------
    crash_at_tick: Optional[int] = None   # satellite reboot at this tick

    def __post_init__(self):
        if not 0.0 <= self.frame_loss_rate + self.frame_corrupt_rate <= 1.0:
            raise ValueError("frame_loss_rate + frame_corrupt_rate must lie "
                             "in [0, 1]")
        if not 0.0 < self.truncate_frac <= 1.0:
            raise ValueError("truncate_frac must lie in (0, 1]")


class FaultInjector:
    """Draws the plan's faults, deterministically, and counts them.

    The counters are the benchmark's injected-fault ground truth:
    ``n_frame_corruptions`` must equal the lane's CRC-failure count and
    ``n_spill_corruptions`` the store's checksum-failure count — 100%
    detection, zero silent acceptance.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.n_frames_lost = 0
        self.n_frame_corruptions = 0
        self.n_spill_corruptions = 0
        self.n_windows_truncated = 0
        self.n_crashes = 0
        self._merge_count = 0
        self._crashed = False

    # -- transmit lane -------------------------------------------------------
    def frame_fate(self) -> str:
        """One of "ok" | "lost" | "corrupt" for a frame transmission."""
        p = self.plan
        if p.frame_loss_rate == 0.0 and p.frame_corrupt_rate == 0.0:
            return "ok"
        u = float(self._rng.random())
        if u < p.frame_loss_rate:
            self.n_frames_lost += 1
            return "lost"
        if u < p.frame_loss_rate + p.frame_corrupt_rate:
            self.n_frame_corruptions += 1
            return "corrupt"
        return "ok"

    def corrupt_bytes(self, data: bytes) -> bytes:
        """Flip one (seeded) bit — a CRC32 always catches a single-bit
        error, so detection downstream is a property of the code, not a
        simulation flag."""
        buf = bytearray(data)
        bit = int(self._rng.integers(0, len(buf) * 8))
        buf[bit // 8] ^= 1 << (bit % 8)
        return bytes(buf)

    def corrupt_offset(self, nbytes: int) -> int:
        """Seeded byte offset for an in-place record flip."""
        return int(self._rng.integers(0, max(nbytes, 1)))

    # -- contact windows -----------------------------------------------------
    def truncate_step_windows(self, windows: List[Tuple[int, int]]
                              ) -> List[Tuple[int, int]]:
        """Apply early-LOS truncation: every ``truncate_every``-th pass
        keeps only the leading ``truncate_frac`` of its ticks (at least
        one — a pass that opened did transmit something)."""
        k = self.plan.truncate_every
        if k <= 0:
            return list(windows)
        out = []
        for i, (lo, hi) in enumerate(windows):
            if (i + 1) % k == 0:
                kept = max(1, int((hi - lo) * self.plan.truncate_frac))
                if lo + kept < hi:
                    self.n_windows_truncated += 1
                hi = min(hi, lo + kept)
            out.append((lo, hi))
        return out

    # -- spill store ---------------------------------------------------------
    def spill_corruption_due(self) -> bool:
        """Called once per store merge; True when this record should be
        corrupted in place (the caller flips the byte and the injector
        counts the injection)."""
        k = self.plan.spill_corrupt_every
        if k <= 0:
            return False
        self._merge_count += 1
        if self._merge_count % k == 0:
            self.n_spill_corruptions += 1
            return True
        return False

    # -- crash ---------------------------------------------------------------
    def crash_due(self, tick: int) -> bool:
        return (self.plan.crash_at_tick is not None and not self._crashed
                and tick >= self.plan.crash_at_tick)

    def note_crash(self) -> None:
        self._crashed = True
        self.n_crashes += 1

    # -- checkpoint bookkeeping ---------------------------------------------
    # A crash rolls the serving state back to its last checkpoint; the
    # injector's counters (and PRNG) roll back WITH it so injected-vs-
    # detected stays an exact invariant across the rewind.  The crash
    # flags themselves never roll back — a crash that fired stays fired.
    def state(self) -> dict:
        s = self._rng.bit_generator.state
        return {
            "n_frames_lost": self.n_frames_lost,
            "n_frame_corruptions": self.n_frame_corruptions,
            "n_spill_corruptions": self.n_spill_corruptions,
            "n_windows_truncated": self.n_windows_truncated,
            "merge_count": self._merge_count,
            # PCG64 state words exceed 64 bits — msgpack only carries
            # uint64, so they travel as decimal strings
            "rng": {"bit_generator": s["bit_generator"],
                    "state": str(s["state"]["state"]),
                    "inc": str(s["state"]["inc"]),
                    "has_uint32": int(s["has_uint32"]),
                    "uinteger": int(s["uinteger"])},
        }

    def load_state(self, d: dict) -> None:
        self.n_frames_lost = int(d["n_frames_lost"])
        self.n_frame_corruptions = int(d["n_frame_corruptions"])
        self.n_spill_corruptions = int(d["n_spill_corruptions"])
        self.n_windows_truncated = int(d["n_windows_truncated"])
        self._merge_count = int(d["merge_count"])
        r = d["rng"]
        if r["bit_generator"] != self._rng.bit_generator.state[
                "bit_generator"]:
            raise ValueError(
                f"fault-plan RNG is {r['bit_generator']!r}, expected "
                f"{self._rng.bit_generator.state['bit_generator']!r}")
        self._rng.bit_generator.state = {
            "bit_generator": r["bit_generator"],
            "state": {"state": int(r["state"]), "inc": int(r["inc"])},
            "has_uint32": int(r["has_uint32"]),
            "uinteger": int(r["uinteger"]),
        }

    @property
    def n_corruptions_injected(self) -> int:
        """Total corruptions across both injection surfaces — the
        benchmark's zero-silent-acceptance denominator."""
        return self.n_frame_corruptions + self.n_spill_corruptions
