"""The port's link and fault copies against the JAX package's, draw for
draw: ``ContactSchedule`` windows and tick windows, the early-LOS
truncation, and the ``TransmitLane`` (unframed and framed ARQ) under
the same seeded ``FaultInjector`` (a twin of
``tests/test_property.py::test_framed_lane_ledger_conserves_bytes``):
the same completions, failed payloads and ``state()`` after every tick,
and the same injector state; the injector's state round trip replays
its stream."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import link as jlink  # noqa: E402
from repro_torch.core import faults, link  # noqa: E402

SETTINGS = dict(max_examples=40, deadline=None)


@given(st.integers(1, 12), st.floats(60.0, 20_000.0), st.integers(0, 99),
       st.sampled_from([0.35, 1.0, 2.5]), st.floats(3_600.0, 86_400.0))
@settings(**SETTINGS)
def test_contact_windows_match_reference(contacts, dur, seed, s_per_step,
                                         horizon):
    kw = dict(contact_duration_s=dur, contacts_per_day=contacts, seed=seed)
    a, j = link.ContactSchedule(**kw), jlink.ContactSchedule(**kw)
    assert a.windows(horizon) == j.windows(horizon)
    assert a.step_windows(s_per_step, horizon) == \
        j.step_windows(s_per_step, horizon)


def test_tiansuan_schedule_windows():
    """The scheduler's default schedule (480 s x 6 a day) at 0.35 s a
    tick, as the tiansuan pair runs it."""
    a, j = link.ContactSchedule(), jlink.ContactSchedule()
    assert a.step_windows(0.35, 86_400.0) == j.step_windows(0.35, 86_400.0)
    assert len(a.windows(86_400.0)) == 6


@given(st.integers(0, 2 ** 32 - 1), st.integers(1, 5),
       st.floats(0.1, 1.0), st.lists(st.tuples(st.integers(0, 5000),
                                               st.integers(1, 40)),
                                     min_size=1, max_size=12))
@settings(**SETTINGS)
def test_truncate_step_windows_match_reference(seed, every, frac, wins):
    wins = sorted((lo, lo + n) for lo, n in wins)
    plan = dict(seed=seed, truncate_every=every, truncate_frac=frac)
    a = faults.FaultInjector(faults.FaultPlan(**plan))
    j = jfaults.FaultInjector(jfaults.FaultPlan(**plan))
    assert a.truncate_step_windows(wins) == j.truncate_step_windows(wins)
    assert a.n_windows_truncated == j.n_windows_truncated


@given(st.integers(0, 2 ** 32 - 1),
       st.floats(0.0, 0.45), st.floats(0.0, 0.45),
       st.sampled_from([None, 16, 64, 256]),
       st.lists(st.integers(1, 600), min_size=1, max_size=8),
       st.integers(10, 200), st.integers(1, 6))
@settings(**SETTINGS)
def test_transmit_lane_matches_reference(seed, loss, corrupt, frame_bytes,
                                         sizes, budget, retries):
    """Both lanes, fed the same payloads and budgets, give the same
    completions, failed payloads (re-enqueued, as the scheduler does) and
    ledger after every tick; the framed ledger is conserved and every
    injected corruption detected."""
    lanes = []
    for lk, fk in ((link, faults), (jlink, jfaults)):
        inj = None
        if frame_bytes is not None:
            inj = fk.FaultInjector(fk.FaultPlan(
                seed=seed, frame_loss_rate=loss, frame_corrupt_rate=corrupt))
        lane = lk.TransmitLane(frame_bytes=frame_bytes, max_retries=retries,
                               injector=inj)
        for i, nb in enumerate(sizes):
            lane.enqueue((i, bool(i % 2)), float(nb))
        lanes.append((lane, inj))
    (a, ai), (j, ji) = lanes
    for _ in range(200):
        assert a.tick(float(budget)) == j.tick(float(budget))
        fa, fj = a.take_failed(), j.take_failed()
        assert fa == fj
        for item, nb in fa:
            a.enqueue(item, nb)
            j.enqueue(item, nb)
        assert a.state() == j.state()
        assert a.pending_payloads() == j.pending_payloads()
        if not len(a):
            break
    assert len(a) == len(j)
    if frame_bytes is not None:
        assert ai.state() == ji.state()
        s = a.state()
        assert abs(s["frame_bytes_attempted"] - (
            s["bytes_sent"] + s["bytes_lost"] + s["bytes_corrupt"])) < 1e-6
        assert s["n_silent_corruptions"] == 0
        assert s["n_corruptions_detected"] == ai.n_frame_corruptions
    assert a.clear() == j.clear()


def test_injector_state_round_trip_replays_stream():
    plan = faults.FaultPlan(seed=11, frame_loss_rate=0.3,
                            frame_corrupt_rate=0.2, spill_corrupt_every=3)
    a = faults.FaultInjector(plan)
    j = jfaults.FaultInjector(jfaults.FaultPlan(**vars(plan)))
    for inj in (a, j):
        for _ in range(7):
            inj.frame_fate()
            inj.spill_corruption_due()
    assert a.state() == j.state()
    saved = a.state()
    first = [a.frame_fate() for _ in range(20)] + \
        [a.corrupt_offset(1000) for _ in range(5)]
    a.load_state(saved)
    again = [a.frame_fate() for _ in range(20)] + \
        [a.corrupt_offset(1000) for _ in range(5)]
    assert first == again
    j.load_state(saved)                  # the port's state reads in the
    assert [j.frame_fate() for _ in range(20)] == first[:20]   # reference
    bad = dict(saved, rng=dict(saved["rng"], bit_generator="MT19937"))
    with pytest.raises(ValueError):
        a.load_state(bad)


def test_fault_plan_and_lane_validation():
    with pytest.raises(ValueError):
        faults.FaultPlan(frame_loss_rate=0.7, frame_corrupt_rate=0.5)
    with pytest.raises(ValueError):
        faults.FaultPlan(truncate_frac=0.0)
    with pytest.raises(ValueError):
        link.TransmitLane(frame_bytes=0)
    with pytest.raises(ValueError):
        link.TransmitLane(injector=faults.FaultInjector(faults.FaultPlan()))
    inj = faults.FaultInjector(faults.FaultPlan(crash_at_tick=5))
    assert not inj.crash_due(4) and inj.crash_due(5)
    inj.note_crash()
    assert not inj.crash_due(6) and inj.n_crashes == 1
    data = bytes(range(16))
    flipped = inj.corrupt_bytes(data)
    diff = np.unpackbits(np.frombuffer(data, np.uint8)
                         ^ np.frombuffer(flipped, np.uint8))
    assert int(diff.sum()) == 1
