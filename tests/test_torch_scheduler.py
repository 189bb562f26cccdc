"""The port's ``PreemptiveScheduler`` on its own invariants, as the JAX
package's ``tests/test_scheduler.py``, ``tests/test_faults.py`` and
``tests/test_property.py`` hold the reference to them: preempt and resume
at every decode step (spill, resident, contiguous) token-exact against an
uninterrupted run; re-preemption ships only a KV delta; random
arrival/preempt/hold traces drain with no page leak and no starvation;
checkpoint -> fresh engine -> restore is token-exact; a spill record
that fails its checksum redoes from prefill, token-exact.  Reduced
smollm-360m in fp32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request, poisson_trace  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402

CFG = get_reduced_config("smollm-360m").with_(param_dtype="float32",
                                              activation_dtype="float32")


_PARAMS = {}


def _shared_params():
    """One seeded init for the whole file (Hypothesis examples included,
    which cannot take a function-scoped fixture)."""
    if "p" not in _PARAMS:
        _PARAMS["p"] = T.init_params(CFG, seed=0, device="cpu")
    return _PARAMS["p"]


@pytest.fixture(scope="module")
def params():
    return _shared_params()


def _prompt(rng, n):
    return rng.integers(1, CFG.vocab_size, n).astype(np.int32)


def _solo_tokens(params, prompt, max_new, **kw):
    eng = ContinuousEngine(CFG, params, n_slots=2, max_seq=64, **kw)
    res = eng.run([Request(prompt=prompt.copy(), max_new=max_new)])
    return list(res.values())[0].tokens


def _assert_drained(eng):
    alloc = getattr(eng.slots, "allocator", None)
    if alloc is not None:
        assert alloc.in_use == 0 and alloc.reserved == 0
        assert len(alloc._free) == alloc.n_pages
        assert alloc._free_set == set(alloc._free)


@pytest.mark.parametrize("mode,layout", [("spill", "paged"),
                                         ("resident", "paged"),
                                         ("spill", "contiguous")])
def test_preempt_resume_every_step(params, mode, layout):
    """Interrupt a probe at every decode step, let a filler churn the
    pool while it is out, resume: the exact uninterrupted tokens."""
    max_new = 6
    rng = np.random.default_rng(42)
    prompt, filler = _prompt(rng, 7), _prompt(rng, 5)
    want = _solo_tokens(params, prompt, max_new, kv_layout=layout)
    eng = ContinuousEngine(CFG, params, n_slots=2, max_seq=64,
                           kv_layout=layout)
    sched = PreemptiveScheduler(eng, preempt_mode=mode)
    for k in range(max_new - 1):
        probe = Request(prompt=prompt.copy(), max_new=max_new)
        sched.submit(probe)
        sched.step(decode=False)
        sched._admit_by_priority()
        for _ in range(k):
            sched.step()
        (slot,) = [s for s in eng.slots.active_slots()
                   if eng.slots.states[s].request.rid == probe.rid]
        sched.preempt(slot)
        assert sched.swapped[probe.rid].spilled == (mode == "spill")
        sched.submit(Request(prompt=filler.copy(), max_new=3))
        sched.step()
        sched.step()
        res = sched.run()
        np.testing.assert_array_equal(res[probe.rid].tokens, want)
        assert res[probe.rid].n_preemptions == 1
        _assert_drained(eng)
    assert sched.n_resumes == sched.n_preemptions == max_new - 1


def test_re_preemption_ships_only_the_delta(params):
    """A long sequence preempted again after a few more decode steps
    ships only the pages dirtied since its first spill, and still
    finishes token-exact."""
    rng = np.random.default_rng(7)
    prompt = _prompt(rng, 30)
    want = _solo_tokens(params, prompt, 20, page_size=8)
    eng = ContinuousEngine(CFG, params, n_slots=1, max_seq=64, page_size=8)
    sched = PreemptiveScheduler(eng)
    req = Request(prompt=prompt.copy(), max_new=20)
    sched.submit(req)
    for _ in range(6):
        sched.step()
    sched.preempt(0)
    first = sched.store.bytes_spilled
    sched.step()                               # resume + decode
    for _ in range(3):
        sched.step()
    sched.preempt(0)
    assert sched.store.n_delta_spills == 1
    assert sched.store.bytes_spilled - first < first
    res = sched.run()
    np.testing.assert_array_equal(res[req.rid].tokens, want)
    assert len(sched.store) == 0
    _assert_drained(eng)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=10, deadline=None)
def test_scheduler_invariants_random_preemption(seed):
    """Random arrivals with random priorities, random preemption (random
    slot and mode) and random transmit-lane page holds: every request
    finishes with max_new tokens, the pool drains exactly, and the
    delta-spill ledger stays consistent."""
    prm = _shared_params()
    rng = np.random.default_rng(seed)
    trace = poisson_trace(5, rate=0.9, prompt_lens=(2, 12), max_new=(1, 7),
                          vocab_size=CFG.vocab_size, seed=seed,
                          priorities=(0, 2))
    eng = ContinuousEngine(CFG, prm, n_slots=2, max_seq=32,
                           kv_layout="paged", page_size=8)
    sched = PreemptiveScheduler(eng)
    for r in sorted(trace, key=lambda r: r.arrival_t):
        sched.submit(r)
    guard, hold_until = 0, -1
    while sched.has_work():
        guard += 1
        assert guard < 500, "scheduler failed to drain (starvation?)"
        active = eng.slots.active_slots()
        if active and rng.random() < 0.3:
            sched.preempt(int(rng.choice(active)),
                          "spill" if rng.random() < 0.7 else "resident")
        if hold_until < 0 and rng.random() < 0.15:
            sched.hold_pages(int(rng.integers(1, 6)))
            hold_until = guard + int(rng.integers(1, 6))
        if 0 <= hold_until <= guard:
            sched.release_hold()
            hold_until = -1
        sched.step(decode=bool(rng.random() < 0.9))
    sched.release_hold()
    by_rid = {r.rid: r for r in trace}
    assert sorted(sched.results) == sorted(by_rid)
    for rid, res in sched.results.items():
        assert len(res.tokens) == by_rid[rid].max_new
        assert int(np.argmax(res.logits_last)) == int(res.tokens[-1])
    _assert_drained(eng)
    assert sched.n_resumes == sched.n_preemptions
    s = sched.stats()
    assert s["n_delta_spills"] <= s["n_spills"] == sched.n_spills
    assert 0 <= s["spill_bytes"] <= s["spill_bytes_full_equiv"]
    assert len(sched.store) == 0 and sched.held_pages == 0


def _mixed_trace():
    rng = np.random.default_rng(5)
    return [Request(prompt=_prompt(rng, int(rng.integers(4, 20))),
                    max_new=int(rng.integers(3, 9)), arrival_t=float(i))
            for i in range(5)]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_checkpoint_restore_into_fresh_engine_is_token_exact(params, layout,
                                                             tmp_path):
    """Checkpoint mid-run (active, spilled and resident swapped sequences,
    queued and finished requests), restore into ``clone_fresh()``: the
    same tokens as the uninterrupted run.  A non-fresh engine refuses."""
    kw = dict(n_slots=2, max_seq=64, kv_layout=layout, page_size=8)
    want_eng = ContinuousEngine(CFG, params, **kw)
    trace = _mixed_trace()
    want = want_eng.run([r.clone() for r in trace])
    want = [want[k].tokens for k in sorted(want)]

    eng = ContinuousEngine(CFG, params, **kw)
    sched = PreemptiveScheduler(eng)
    reqs = [r.clone() for r in trace]
    for r in reqs:
        sched.submit(r)
    for t in range(6):
        sched.step()
        if t == 3:
            sched.preempt(eng.slots.active_slots()[0], "spill")
    if layout == "paged" and eng.slots.active_slots():
        sched.preempt(eng.slots.active_slots()[0], "resident")
    path = str(tmp_path / "s.ckpt")
    assert sched.checkpoint(path, extra_meta={"note": "x"}) > 0
    with pytest.raises(RuntimeError, match="FRESH"):
        sched.restore(path)
    fresh = PreemptiveScheduler(eng.clone_fresh())
    assert fresh.restore(path) == {"note": "x"}
    assert fresh.clock == eng.clock and fresh.swapped
    res = fresh.run()
    got = [res[r.rid].tokens for r in reqs]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _assert_drained(fresh.engine)


def test_corrupt_spill_redoes_from_prefill_token_exact(params):
    """Every spill record corrupted at merge: each resume detects it and
    redoes the request from prefill, with the uninterrupted tokens."""
    rng = np.random.default_rng(3)
    prompt = _prompt(rng, 9)
    want = _solo_tokens(params, prompt, 8)
    eng = ContinuousEngine(CFG, params, n_slots=2, max_seq=64)
    inj = FaultInjector(FaultPlan(spill_corrupt_every=1))
    sched = PreemptiveScheduler(eng, fault_injector=inj)
    req = Request(prompt=prompt.copy(), max_new=8)
    sched.submit(req)
    for _ in range(3):
        sched.step()
    sched.preempt(0)
    res = sched.run()
    np.testing.assert_array_equal(res[req.rid].tokens, want)
    assert sched.n_redo_from_corruption == 1
    assert sched.store.n_corruptions_detected == inj.n_spill_corruptions == 1
    _assert_drained(eng)


def test_preempt_mode_validation(params):
    eng = ContinuousEngine(CFG, params, n_slots=1, max_seq=64)
    with pytest.raises(ValueError):
        PreemptiveScheduler(eng, preempt_mode="swap")
    with pytest.raises(RuntimeError, match="empty slot"):
        PreemptiveScheduler(eng).preempt(0)
