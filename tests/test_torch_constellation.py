"""The port's ``serving/constellation.py`` (with ``ContactSchedule``'s
window sets and ``FleetEnergy``) as the JAX package's
``tests/test_constellation.py`` holds the reference to it: a handover at
every decode step is token-exact, the planner keeps station capacity and
value order, whole replays hand over, deliver token-exactly (with and
without faults), own every rid once and drain, and the scheduler refuses
contiguous and prefix-cached engines.  Then against the reference: the
window sets and fleet ledgers are equal, both packages' schedulers on the
bench's constellation trace (``CN_*`` in benchmarks/serving_throughput.py)
give the same tokens, clock, handovers, per-tick assignments, fleet
totals and lane stats, and a handover file packed by either package
grafts in the other and resumes to the same tokens.  Reduced smollm-360m
in fp32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.core.energy import FleetEnergy  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.core.link import ContactSchedule, TransmitLane  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.constellation import (  # noqa: E402
    ConstellationScheduler, ContactPlanner, graft_sequence, pack_request,
    pack_sequence, priority_weight)
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402

MAX_SEQ = 64
PAGE = 8
POOL = 12
F32 = dict(param_dtype="float32", activation_dtype="float32")
CFG = get_reduced_config("smollm-360m").with_(**F32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers, where spinning thread pools oversubscribe
    the cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def params():
    return T.init_params(CFG, seed=0, device="cpu")


def _mk_engine(params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", PAGE)
    kw.setdefault("pool_pages", POOL)
    kw.setdefault("prefill_budget_tokens", 16)
    return ContinuousEngine(CFG, params, **kw)


def _assert_drained(eng):
    alloc = eng.slots.allocator
    assert alloc.in_use == 0 and alloc.reserved == 0
    assert len(alloc._free) == alloc.n_pages


def _prompt(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)


def _drain(sched):
    while sched.has_work():
        sched.step()
    return sched.results


def _solo_tokens(params, prompt, max_new):
    eng = _mk_engine(params)
    rid = eng.submit(Request(prompt=prompt.copy(), max_new=max_new))
    return np.asarray(_drain(PreemptiveScheduler(eng))[rid].tokens)


# ---------------------------------------------------------------------------
# per-step spill -> transmit -> graft exactness
# ---------------------------------------------------------------------------

def _handover_sweep(params, tmp, *, max_new=6, interrupts=None,
                    frame_bytes=96, lane_budget=512.0):
    """Interrupt a probe at decode step k, ship it over a framed lane,
    graft it on a fresh PEER scheduler: the uninterrupted tokens."""
    prompt = _prompt()
    want = _solo_tokens(params, prompt, max_new)
    src_eng = _mk_engine(params)
    n_grafts = 0
    for k in (interrupts if interrupts is not None else range(max_new)):
        src = PreemptiveScheduler(src_eng)
        rid = src.submit(Request(prompt=prompt.copy(), max_new=max_new))
        for _ in range(k):
            src.step()
        if rid in src.results:
            continue
        path = str(tmp / f"seq_{k}.ckpt")
        queued = next((r for r in src_eng.queue.items() if r.rid == rid),
                      None)
        if queued is not None:
            src_eng.queue.take(queued)
            nbytes = pack_request(path, queued)
        else:
            if rid not in src.swapped:
                slot = next(s for s in src_eng.slots.active_slots()
                            if src_eng.slots.states[s].request.rid == rid)
                src.preempt(slot, "spill")
            entry = src.swapped.pop(rid)
            kv = entry.kv
            if kv is None and src.store is not None and rid in src.store:
                kv = src.store.snapshot(rid)
            src.store.drop(rid)
            nbytes = pack_sequence(path, entry, kv, entry.preempted_step)
        assert nbytes > 0
        lane = TransmitLane(frame_bytes=frame_bytes)
        lane.enqueue(("seq", rid, 1, path), nbytes)
        ticks = 0
        while not lane.tick(lane_budget):
            ticks += 1
            assert ticks < 10_000
        dst = PreemptiveScheduler(_mk_engine(params))
        assert graft_sequence(dst, path) == rid
        res = _drain(dst)
        np.testing.assert_array_equal(np.asarray(res[rid].tokens), want)
        _assert_drained(dst.engine)
        _assert_drained(src_eng)
        assert len(dst.store) == 0 and len(src.store) == 0
        n_grafts += 1
    assert n_grafts > 0


def test_handover_exact_every_step_dense(params, tmp_path):
    _handover_sweep(params, tmp_path)


def test_handover_exact_tiny_frames(params, tmp_path):
    _handover_sweep(params, tmp_path, interrupts=[3], frame_bytes=32,
                    lane_budget=96.0)


# ---------------------------------------------------------------------------
# contact planner
# ---------------------------------------------------------------------------

def _uniform_windows(n_sats, n_stations, hi=100):
    return {(k, m): [(0, hi)] for k in range(n_sats)
            for m in range(n_stations)}


def test_planner_station_capacity():
    p = ContactPlanner(_uniform_windows(4, 2), 4, 2)
    out = p.assign(0, {k: (10.0, 1.0) for k in range(4)})
    assert len(out) <= 2
    assert len(set(out.values())) == len(out)


def test_planner_value_ordering():
    p = ContactPlanner(_uniform_windows(3, 1), 3, 1)
    assert p.assign(0, {0: (10.0, 1.0), 1: (10.0, 1.0),
                        2: (30.0, 1.0)}) == {0: 2}
    assert p.assign(0, {0: (10.0, 4.0), 1: (10.0, 1.0),
                        2: (0.0, 1.0)}) == {0: 1}


def test_planner_zero_value_never_assigned():
    p = ContactPlanner(_uniform_windows(2, 2), 2, 2)
    assert p.assign(0, {0: (0.0, 1.0), 1: (0.0, 1.0)}) == {}


def test_planner_static_home_stations():
    p = ContactPlanner(_uniform_windows(3, 2), 3, 2, policy="static")
    assert p.assign(0, {k: (5.0, 1.0) for k in range(3)}) == {0: 0, 1: 1}


def test_planner_respects_windows():
    ws = {(0, 0): [(10, 20)], (0, 1): [], (1, 0): [], (1, 1): [(0, 5)]}
    p = ContactPlanner(ws, 2, 2)
    assert p.assign(0, {0: (5.0, 1.0), 1: (5.0, 1.0)}) == {1: 1}
    assert p.assign(12, {0: (5.0, 1.0), 1: (5.0, 1.0)}) == {0: 0}
    assert p.next_open(0, 0) == 10 and p.next_open(1, 7) is None


def test_step_window_sets_shape_determinism_and_reference():
    """Deterministic, one entry per pair, distinct jitter streams, the
    sparse plane sparse, and equal to the reference's dict pair for pair
    (the test's sets and the constellation config's)."""
    from repro.core.link import ContactSchedule as JSchedule
    sched = ContactSchedule(contact_duration_s=8.0, contacts_per_day=600,
                            seed=5)
    kw = dict(n_satellites=3, n_stations=2, contacts_per_day=[60, 600, 600])
    a = sched.step_window_sets(1.0, 3600.0, **kw)
    assert a == sched.step_window_sets(1.0, 3600.0, **kw)
    assert set(a) == {(k, m) for k in range(3) for m in range(2)}
    assert a[(1, 0)] != a[(2, 0)] or a[(1, 1)] != a[(2, 1)]
    assert len(a[(0, 0)]) < len(a[(1, 0)])
    assert a == JSchedule(contact_duration_s=8.0, contacts_per_day=600,
                          seed=5).step_window_sets(1.0, 3600.0, **kw)
    from repro.configs.tiansuan_constellation import CONSTELLATION as JC
    from repro_torch.configs.tiansuan_constellation import CONSTELLATION as C
    assert C == JC
    kw = dict(n_satellites=C["n_satellites"], n_stations=C["n_stations"],
              contacts_per_day=C["contacts_per_day"])
    mine = ContactSchedule(contact_duration_s=C["contact_duration_s"],
                           seed=C["schedule_seed"]).step_window_sets(
        C["s_per_step"], C["horizon_s"], **kw)
    assert mine == JSchedule(contact_duration_s=C["contact_duration_s"],
                             seed=C["schedule_seed"]).step_window_sets(
        C["s_per_step"], C["horizon_s"], **kw)
    assert len(mine[(0, 0)]) < len(mine[(1, 0)])


def test_priority_weight_floors_at_one():
    assert priority_weight(0) == 1.0
    assert priority_weight(3) == 4.0
    assert priority_weight(-2) == 1.0


def test_fleet_energy_matches_reference():
    from repro.core.energy import FleetEnergy as JFleet
    rng = np.random.default_rng(4)
    fleets = (FleetEnergy(3), JFleet(3))
    for _ in range(40):
        k, op = int(rng.integers(3)), int(rng.integers(3))
        s, n = float(rng.uniform(0.1, 2.0)), float(rng.integers(0, 5000))
        for f in fleets:
            (f.charge_compute(k, 1, s) if op == 0 else
             f.charge_downlink(k, s, n) if op == 1 else
             f.charge_isl(k, s, n))
    mine, ref = fleets
    assert [l.counters for l in mine.ledgers] == \
        [l.counters for l in ref.ledgers]
    assert mine.totals() == ref.totals()
    assert [mine.energy_j(k) for k in range(3)] == \
        [ref.energy_j(k) for k in range(3)]
    for h in (1.0, 60.0, 7200.0):
        assert mine.within_budget(h) == ref.within_budget(h)
    with pytest.raises(ValueError):
        FleetEnergy(0)


# ---------------------------------------------------------------------------
# full constellation replays
# ---------------------------------------------------------------------------

def _constellation(params, *, n_sats=3, horizon_s=600.0, **kw):
    engines = [_mk_engine(params) for _ in range(n_sats)]
    ws = kw.pop("window_sets", None)
    if ws is None:
        ws = ContactSchedule(contact_duration_s=6.0, contacts_per_day=2400,
                             seed=3).step_window_sets(
            1.0, horizon_s, n_satellites=n_sats, n_stations=2,
            contacts_per_day=[12, 2400, 2400][:n_sats])
    kw.setdefault("n_stations", 2)
    kw.setdefault("s_per_step", 1.0)
    kw.setdefault("handover_margin_ticks", 16)
    return ConstellationScheduler(engines, window_sets=ws,
                                  horizon_s=horizon_s, **kw)


def _trace(n=5, seed=0, max_new=6):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, CFG.vocab_size,
                                        size=6).astype(np.int32),
                    max_new=max_new, arrival_t=0.0) for _ in range(n)]


def _check_replay(cs, rep, reqs, want):
    assert rep.n_handovers > 0
    assert not rep.undelivered
    assert set(rep.tokens) == {r.rid for r in reqs}
    for rid, toks in rep.tokens.items():
        np.testing.assert_array_equal(toks, want[rid])
    for sat in cs.sats:
        _assert_drained(sat.engine)
        assert len(sat.store) == 0
    for lane in [*cs.lanes, *cs.isl]:
        assert len(lane) == 0 and not lane.take_failed()


def test_constellation_handover_token_exact(params):
    reqs = _trace()
    want = {r.rid: _solo_tokens(params, r.prompt, r.max_new) for r in reqs}
    cs = _constellation(params)
    rep = cs.run([reqs, [], []])
    _check_replay(cs, rep, reqs, want)
    assert rep.fleet[0].get("bytes_isl", 0) > 0


def test_constellation_handover_under_faults(params):
    reqs = _trace(seed=2)
    want = {r.rid: _solo_tokens(params, r.prompt, r.max_new) for r in reqs}
    inj = FaultInjector(FaultPlan(seed=11, frame_loss_rate=0.2,
                                  frame_corrupt_rate=0.15,
                                  spill_corrupt_every=3))
    cs = _constellation(params, frame_bytes=256, link_max_retries=6,
                        faults=inj, horizon_s=1200.0)
    rep = cs.run([reqs, [], []])
    _check_replay(cs, rep, reqs, want)
    assert inj.n_corruptions_injected > 0
    lanes = [*rep.lane_stats, *rep.isl_stats]
    assert sum(l["n_corruptions_detected"] for l in lanes) > 0
    assert sum(l["n_silent_corruptions"] for l in lanes) == 0


def test_constellation_no_handover_without_peer_advantage(params):
    ws = {(k, m): [(0, 600)] for k in range(2) for m in range(2)}
    cs = ConstellationScheduler([_mk_engine(params) for _ in range(2)],
                                window_sets=ws, n_stations=2,
                                s_per_step=1.0, horizon_s=600.0,
                                handover_margin_ticks=16)
    rep = cs.run([_trace(n=3, seed=4), []])
    assert rep.n_handovers == 0 and not rep.undelivered


def test_constellation_ownership_is_single(params):
    reqs = _trace(n=4, seed=1)
    cs = _constellation(params)
    for r in reqs:
        cs.sats[0].submit(r)
    guard = 0
    while cs.has_work() and cs.clock < cs.horizon_steps:
        cs.tick()
        guard += 1
        assert guard < 5000
        assert all(len(s) == 1 for s in cs.ownership().values())
        grants = cs.last_assignment
        assert len(grants) <= cs.n_stations
        assert len(set(grants.values())) == len(grants)


def test_constellation_rejects_contiguous_engines(params):
    eng = ContinuousEngine(CFG, params, n_slots=2, max_seq=MAX_SEQ,
                           kv_layout="contiguous")
    with pytest.raises(ValueError, match="paged"):
        ConstellationScheduler([eng], window_sets={}, n_stations=1)


def test_constellation_rejects_prefix_cache(params):
    eng = _mk_engine(params, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache"):
        ConstellationScheduler([eng], window_sets={}, n_stations=1)


def test_constellation_temporary_files_go_with_the_scheduler(params):
    import gc
    import os
    cs = _constellation(params)
    tmp = cs._tmp.name
    cs.run([_trace(n=2), [], []])
    assert os.path.isdir(tmp) and not os.listdir(tmp)
    del cs
    gc.collect()
    assert not os.path.exists(tmp)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    import jax
    from repro.config import get_reduced_config as j_reduced
    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    jcfg = j_reduced("smollm-360m").with_(**F32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    return jcfg, jp, params_from_numpy(jax.device_get(jp), CFG, device="cpu")


def _bench_trace(B, vocab):
    """benchmarks/serving_throughput.py::_constellation_trace (CN_*), with
    the same rids on both sides: a handover file's meta holds the rid, and
    its msgpack size (which the ISL meters) follows the rid's value."""
    rng = np.random.default_rng(9)
    return [B.Request(prompt=rng.integers(1, vocab, int(rng.integers(6, 12)))
                      .astype(np.int32),
                      max_new=int(rng.integers(4, 11)), arrival_t=float(i),
                      rid=1000 + i)
            for i in range(8)]


def _bench_replay(mods, cfg, params, policy, handover, faulted):
    """benchmarks/serving_throughput.py::_serve_constellation through
    ``ConstellationScheduler.run``, the instance's ``tick`` wrapped to log
    the planner's grants."""
    E, B, L, F, C = mods
    engines = [E.ContinuousEngine(cfg, params, n_slots=2, max_seq=MAX_SEQ,
                                  kv_layout="paged", page_size=PAGE,
                                  pool_pages=POOL, prefill_budget_tokens=16)
               for _ in range(3)]
    ws = L.ContactSchedule(contact_duration_s=6.0, contacts_per_day=2400,
                           seed=3).step_window_sets(
        1.0, 600.0, n_satellites=3, n_stations=2,
        contacts_per_day=[144, 2400, 2400])
    kw = {}
    if faulted:
        kw.update(faults=F.FaultInjector(F.FaultPlan(
            seed=11, frame_loss_rate=0.2, frame_corrupt_rate=0.15,
            spill_corrupt_every=3)), frame_bytes=256, link_max_retries=6)
    cs = C.ConstellationScheduler(engines, window_sets=ws, n_stations=2,
                                  s_per_step=1.0, horizon_s=600.0,
                                  policy=policy, handover=handover,
                                  handover_margin_ticks=16, **kw)
    trace = _bench_trace(B, cfg.vocab_size)
    tick, grants = cs.tick, []

    def logged_tick():
        t = cs.clock
        tick()
        grants.append((t, sorted(cs.last_assignment.items())))

    cs.tick = logged_tick
    rep = cs.run([trace, [], []])
    del cs.tick
    return rep, [r.rid for r in trace], grants


@pytest.mark.parametrize("policy,handover,faulted",
                         [("value", True, False), ("static", False, False),
                          ("value", True, True)])
def test_constellation_matches_reference(bridged, monkeypatch, policy,
                                        handover, faulted):
    """Handover files are written raw by both packages here, as on the
    card's machine (no zstandard there): a zstd-compressed KV leaf's size
    follows its low-order bits, which the two frameworks' fp32 GEMMs
    leave different, and the ISL meters file bytes."""
    from repro.checkpoint import store as jstore
    from repro.core import faults as jF, link as jL
    from repro.serving import batching as jB, constellation as jC
    from repro.serving import engine as jE
    from repro_torch.core import faults as tF, link as tL
    from repro_torch.serving import batching as tB, constellation as tC
    from repro_torch.checkpoint import store as tstore
    from repro_torch.serving import engine as tE
    monkeypatch.setattr(jstore, "zstd", None)
    monkeypatch.setattr(tstore, "zstd", None)
    jcfg, jp, tp = bridged
    jrep, jrids, jg = _bench_replay((jE, jB, jL, jF, jC), jcfg, jp, policy,
                                    handover, faulted)
    trep, trids, tg = _bench_replay((tE, tB, tL, tF, tC), CFG, tp, policy,
                                    handover, faulted)
    for a, b in zip(trids, jrids):
        np.testing.assert_array_equal(trep.tokens[a], jrep.tokens[b])
    assert len(trep.tokens) == len(jrep.tokens) == len(jrids)
    assert tg == jg
    for key in ("final_clock", "n_handovers", "n_result_forwards",
                "n_handover_redos", "assigned_pass_ticks", "goodput",
                "delivered_tokens", "within_energy_budget", "lane_stats",
                "isl_stats"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert sorted(trep.fleet_totals) == sorted(jrep.fleet_totals)
    for k, v in jrep.fleet_totals.items():
        assert trep.fleet_totals[k] == pytest.approx(v, rel=1e-12)
    assert trep.fleet == jrep.fleet
    assert not trep.undelivered
    if handover:
        assert trep.n_handovers > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_handover_file_crosses_packages(bridged, tmp_path, writer):
    """A sequence spilled mid-decode and packed by one package grafts on
    the other's peer and finishes with the solo run's tokens."""
    from repro.serving import batching as jB, constellation as jC
    from repro.serving import engine as jE, scheduler as jS
    from repro_torch.serving import batching as tB, constellation as tC
    from repro_torch.serving import engine as tE, scheduler as tS
    jcfg, jp, tp = bridged
    sides = {"jax": (jE, jB, jS, jC, jcfg, jp),
             "port": (tE, tB, tS, tC, CFG, tp)}
    prompt = _prompt(n=11, seed=8)
    E, B, S, C, cfg, p = sides[writer]
    eng = E.ContinuousEngine(cfg, p, n_slots=2, max_seq=MAX_SEQ,
                             kv_layout="paged", page_size=PAGE,
                             pool_pages=POOL, prefill_budget_tokens=16)
    src = S.PreemptiveScheduler(eng)
    rid = src.submit(B.Request(prompt=prompt.copy(), max_new=10))
    for _ in range(4):
        src.step()
    src.preempt(eng.slots.active_slots()[0], "spill")
    entry = src.swapped.pop(rid)
    kv = src.store.snapshot(rid)
    path = str(tmp_path / "seq.ckpt")
    C.pack_sequence(path, entry, kv, entry.preempted_step)
    src.store.drop(rid)
    want = _solo_tokens(tp, prompt, 10)
    E, B, S, C, cfg, p = sides["port" if writer == "jax" else "jax"]
    dst = S.PreemptiveScheduler(E.ContinuousEngine(
        cfg, p, n_slots=2, max_seq=MAX_SEQ, kv_layout="paged",
        page_size=PAGE, pool_pages=POOL, prefill_budget_tokens=16))
    assert C.graft_sequence(dst, path) == rid
    while dst.has_work():
        dst.step()
    np.testing.assert_array_equal(np.asarray(dst.results[rid].tokens), want)
