"""The slice as a whole against the JAX package: the reference's and the
port's ``SpaceGroundScheduler`` on the same bridged fp32 weights
(reduced smollm-360m) and the reference bench's traces
(``benchmarks/serving_throughput.py``): the fault replay without faults
and with every fault armed (frame loss and corruption, truncated passes,
corrupted spill merges, a crash at tick 25 restored from a checkpoint)
under the bench's plan seed 0 and its chaos seeds 1-4, and the
speculative cascade (draft-id escalation).  The two must give
identical tokens, escalated and undelivered lists, reboots, scheduler
stats (the wall-clock resume latencies apart), lane stats and
speculative counters, and ledger counters within 1e-9 relative.  Runs
are compared by submission order: each package has its own rid counter.
Serving checkpoints cross both ways: one written by the reference's
scheduler restores into the port's, and one written by the port loads in
the reference's ``load_checkpoint_raw`` bit for bit and restores there,
token-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import faults as jF, gating as jG, link as jL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import batching as jB, engine as jE  # noqa: E402
from repro.serving import scheduler as jS  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.core import (faults as tF, gating as tG,  # noqa: E402
                              link as tL)
from repro_torch.serving import batching as tB, engine as tE  # noqa: E402
from repro_torch.serving import scheduler as tS  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
JAX_MODS = (jE, jS, jF, jG, jL, jB)
PORT_MODS = (tE, tS, tF, tG, tL, tB)


@pytest.fixture(scope="module")
def weights():
    from repro.config import get_reduced_config as j_reduced
    jcfg = j_reduced("smollm-360m").with_(**F32)
    tcfg = get_reduced_config("smollm-360m").with_(**F32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
    tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    return {"jax": (jcfg, jp), "port": (tcfg, tp)}


def _fault_trace(B, vocab):
    """benchmarks/serving_throughput.py::_fault_trace."""
    rng = np.random.default_rng(3)
    return [B.Request(prompt=rng.integers(1, vocab, int(rng.integers(8, 14)))
                      .astype(np.int32),
                      max_new=int(rng.integers(10, 18)),
                      arrival_t=float(i * 2))
            for i in range(8)]


def _cascade_trace(B, vocab):
    """benchmarks/serving_throughput.py::_spec_cascade_trace."""
    rng = np.random.default_rng(5)
    return [B.Request(prompt=rng.integers(1, vocab, int(rng.integers(24, 41)))
                      .astype(np.int32),
                      max_new=int(rng.integers(6, 13)), arrival_t=float(i * 2))
            for i in range(6)]


def _serve(mods, cfg, params, kind):
    """One replay, as the bench's ``_serve_fault`` (kind "clean", or
    "faults<seed>" with that FaultPlan seed) or ``_serve_spec_cascade``
    (kind "speculative")."""
    E, S, F, G, L, B = mods
    sched = L.ContactSchedule(contact_duration_s=4.0, contacts_per_day=8640,
                              seed=3)
    kw = dict(schedule=sched, s_per_step=1.0, horizon_s=7200.0,
              comm_reserve_pages=4)
    if kind == "speculative":
        sat = E.ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                                 prefill_budget_tokens=8)
        gnd = E.ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                                 draft_k=8)
        kw.update(gate=G.ConfidenceGate("max_prob", 0.9), speculative=True)
        trace = _cascade_trace(B, cfg.vocab_size)
    else:
        sat = E.ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                                 kv_layout="paged", page_size=8,
                                 pool_pages=9, prefill_budget_tokens=8)
        gnd = E.ContinuousEngine(cfg, params, n_slots=2, max_seq=64)
        kw.update(gate=G.ConfidenceGate("max_prob", 0.6))
        trace = _fault_trace(B, cfg.vocab_size)
    if kind.startswith("faults"):
        kw.update(faults=F.FaultInjector(F.FaultPlan(
            seed=int(kind[6:]), frame_loss_rate=0.25, frame_corrupt_rate=0.2,
            truncate_every=3, spill_corrupt_every=2, crash_at_tick=25)),
            frame_bytes=32, link_max_retries=6, checkpoint_every=8)
    sg = S.SpaceGroundScheduler(sat, gnd, **kw)
    rid0 = [r.rid for r in trace]
    rep = sg.run(trace)
    return rep, rid0, sg


def _by_order(rep, rids):
    """The report's rid-keyed answers in submission order."""
    pos = {rid: i for i, rid in enumerate(rids)}
    return ([rep.tokens[r] for r in rids], sorted(pos[r] for r in
                                                   rep.escalated),
            sorted(pos[r] for r in rep.undelivered))


@pytest.mark.parametrize("kind", ["clean", "speculative",
                                  *(f"faults{seed}" for seed in range(5))])
def test_space_ground_matches_reference(weights, kind):
    jrep, jrids, jsg = _serve(JAX_MODS, *weights["jax"], kind)
    trep, trids, tsg = _serve(PORT_MODS, *weights["port"], kind)
    jt, jesc, jund = _by_order(jrep, jrids)
    tt, tesc, tund = _by_order(trep, trids)
    assert len(tt) == len(jt) == len(jrids)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    assert (tesc, tund) == (jesc, jund)
    faulted = kind.startswith("faults")
    assert trep.n_reboots == jrep.n_reboots == int(faulted)
    timing = ("resume_latency_s_mean", "resume_latency_s_max")
    assert {k: v for k, v in trep.sat_stats.items() if k not in timing} == \
        {k: v for k, v in jrep.sat_stats.items() if k not in timing}
    assert trep.lane_stats == jrep.lane_stats
    assert trep.spec_stats == jrep.spec_stats
    assert trep.windows == jrep.windows
    assert trep.decode_steps_in_window == jrep.decode_steps_in_window
    assert sorted(trep.ledger.counters) == sorted(jrep.ledger.counters)
    for k, v in jrep.ledger.counters.items():
        assert trep.ledger.counters[k] == pytest.approx(v, rel=1e-9, abs=0)
    alloc = tsg.sat.engine.slots.allocator
    assert alloc.in_use == 0 and alloc.reserved == 0
    assert len(tsg.sat.store) == 0
    if faulted:
        inj = tsg.faults
        assert inj.state() == jsg.faults.state()
        assert (trep.lane_stats["n_corruptions_detected"]
                + trep.sat_stats["n_spill_corruptions_detected"]
                == inj.n_corruptions_injected > 0)
    if kind == "speculative":
        assert trep.spec_stats["verify_passes"] > 0


def _half_run(mods, cfg, params, path, trace):
    """Serve ``trace`` through a PreemptiveScheduler for a few ticks, with
    a spill and a resident preemption, and checkpoint it to ``path``."""
    E, S = mods[0], mods[1]
    eng = E.ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                             page_size=8)
    sched = S.PreemptiveScheduler(eng)
    for r in trace:
        sched.submit(r)
    for t in range(5):
        sched.step()
        if t == 2:
            sched.preempt(eng.slots.active_slots()[0], "spill")
    sched.preempt(eng.slots.active_slots()[0], "resident")
    sched.checkpoint(path, extra_meta={"from": "x"})
    return eng


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serving_checkpoint_crosses_frameworks(weights, tmp_path, writer):
    """A mid-run serving checkpoint written by one package restores into
    the other's fresh scheduler and finishes with the tokens of an
    uninterrupted run; its leaves load bit for bit in both stores."""
    path = str(tmp_path / "sg.ckpt")
    mods = {"jax": JAX_MODS, "port": PORT_MODS}
    reader = "port" if writer == "jax" else "jax"
    w_cfg, w_params = weights[writer]
    trace = _fault_trace(mods[writer][5], w_cfg.vocab_size)
    want_eng = mods[writer][0].ContinuousEngine(w_cfg, w_params, n_slots=2,
                                                max_seq=64, page_size=8)
    want = want_eng.run([r.clone() for r in trace])
    want = [want[k].tokens for k in sorted(want)]
    _half_run(mods[writer], w_cfg, w_params, path, trace)

    jl, jmeta = jstore.load_checkpoint_raw(path)
    tl, tmeta = tstore.load_checkpoint_raw(path)
    assert jmeta == tmeta and sorted(jl) == sorted(tl)
    assert any(k.startswith("kv/") for k in tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))

    r_cfg, r_params = weights[reader]
    E, S = mods[reader][0], mods[reader][1]
    fresh = S.PreemptiveScheduler(E.ContinuousEngine(
        r_cfg, r_params, n_slots=2, max_seq=64, page_size=8))
    assert fresh.restore(path) == {"from": "x"}
    res = fresh.run()
    rids = sorted({*map(int, jmeta["requests"]), *map(int, jmeta["results"])})
    got = [res[r].tokens for r in rids]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
