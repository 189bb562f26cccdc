"""The port's prefix cache (``PagePrefixIndex``, copy-on-write forks and
the engine's shared-prefix admission), as the JAX package's
``tests/test_prefix_cache.py`` holds the reference to it: the radix index
alone, shared serving token-exact with and cheaper than unshared, a
fully covered prompt paying one position, CoW never corrupting the
cached prefix, spill/resume and store-eviction redo with pinned shared
pages.  Then against the reference itself: both packages' engines serve
the bench's shared-prefix trace shape on bridged fp32 weights with the
same tokens and the same ``kv_cache_stats``, and random
match/insert/evict/clear traces keep refcounts exact, ``reclaimable()``
equal to what ``evict`` frees, in lockstep with the reference's index.
Reduced smollm-360m in fp32 on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.paging import (BlockAllocator,  # noqa: E402
                                        PagePrefixIndex, PoolExhausted)
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402

PS = 16
F32 = dict(param_dtype="float32", activation_dtype="float32")
CFG = get_reduced_config("smollm-360m").with_(**F32)
SETTINGS = dict(max_examples=30, deadline=None)


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


def _engine(params, *, prefix_cache, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_seq", 128)
    return ContinuousEngine(CFG, params, kv_layout="paged", page_size=PS,
                            prefix_cache=prefix_cache, **kw)


def _shared_trace(*, n=8, header_pages=2, seed=3):
    """n requests over ONE header of ``header_pages`` full pages, each
    with a unique tail; the last repeats request 0's prompt."""
    rng = np.random.default_rng(seed)
    header = rng.integers(1, CFG.vocab_size, header_pages * PS).astype(
        np.int32)
    out = []
    for i in range(n - 1):
        tail = rng.integers(1, CFG.vocab_size, 3 + i).astype(np.int32)
        out.append(Request(prompt=np.concatenate([header, tail]),
                           max_new=4, arrival_t=float(2 * i)))
    out.append(Request(prompt=out[0].prompt.copy(), max_new=3,
                       arrival_t=float(2 * n)))
    return out


def _drained(eng):
    a = eng.slots.allocator
    if eng.slots.prefix_index is not None:
        eng.slots.prefix_index.clear()
    return (a.in_use == 0 and a.reserved == 0 and a.n_live_refs() == 0
            and len(a._free) == a.n_pages)


def _pairs(res_a, res_b):
    return [(res_a[a].tokens, res_b[b].tokens)
            for a, b in zip(sorted(res_a), sorted(res_b))]


# ---------------------------------------------------------------------------
# the radix index in isolation
# ---------------------------------------------------------------------------

def test_prefix_index_match_attach_evict_refcounts():
    a = BlockAllocator(8)
    idx = PagePrefixIndex(a, 4)
    toks = np.arange(1, 13, dtype=np.int32)       # 3 full pages
    a.reserve(3)
    pages = a.alloc(3)
    idx.insert(toks, pages)
    assert all(a.refcount(p) == 2 for p in pages)  # caller + index
    a.release(pages)
    assert all(a.refcount(p) == 1 for p in pages)  # index keeps them live
    assert a.in_use == 3 and idx.reclaimable() == 3
    assert list(idx.match(toks)) == list(pages)
    assert idx.match(toks[:7]) == pages[:1]        # page-granular
    assert idx.match(np.flip(toks).copy()) == []
    for got in (3, 1, 0):
        idx.note_attach(got)
    assert idx.hits == 2 and idx.misses == 1 and idx.pages_attached == 4
    assert idx.evict(1) == 1 and a.in_use == 2     # leaf-first
    assert idx.match(toks) == pages[:2]
    idx.clear()
    assert a.in_use == 0 and a.n_live_refs() == 0


def test_prefix_index_shared_interior_survives_leaf_eviction():
    a = BlockAllocator(8)
    idx = PagePrefixIndex(a, 4)
    head = np.arange(1, 5, dtype=np.int32)
    for salt in (50, 60):                          # two branches, one head
        toks = np.concatenate([head, np.arange(salt, salt + 4,
                                               dtype=np.int32)])
        a.reserve(2)
        idx.insert(toks, a.alloc(2))
    for p in range(1, 5):
        a.release([p])                             # callers all finished
    assert a.in_use == 3 and idx.reclaimable() == 3
    idx.evict(1)                                   # the head is interior
    assert len(idx.match(np.concatenate(
        [head, np.arange(50, 54, dtype=np.int32)]))) + len(idx.match(
            np.concatenate([head, np.arange(60, 64,
                                            dtype=np.int32)]))) == 3
    idx.clear()
    assert a.in_use == 0


def test_share_of_free_page_raises():
    a = BlockAllocator(4)
    with pytest.raises(PoolExhausted):
        a.share([1])
    a.reserve(1)
    pages = a.alloc(1)
    a.share(pages)
    a.release(pages)
    assert a.refcount(pages[0]) == 1 and a.in_use == 1
    a.release(pages)
    assert a.in_use == 0
    with pytest.raises(PoolExhausted):
        a.release(pages)


# ---------------------------------------------------------------------------
# end to end: shared serving is token-exact and does less work
# ---------------------------------------------------------------------------

def test_shared_replay_token_exact_and_cheaper(params):
    trace = _shared_trace()
    runs = {}
    for pc in (True, False):
        eng = _engine(params, prefix_cache=pc)
        res = eng.run([r.clone() for r in trace])
        runs[pc] = (eng, [res[k].tokens for k in sorted(res)])
    (eng_s, toks_s), (eng_u, toks_u) = runs[True], runs[False]
    assert len(toks_s) == len(toks_u)
    for a, b in zip(toks_s, toks_u):
        np.testing.assert_array_equal(a, b)
    assert eng_s.prefill_tokens_total < eng_u.prefill_tokens_total
    assert (eng_s.slots.allocator.peak_in_use
            < eng_u.slots.allocator.peak_in_use)
    stats = eng_s.kv_cache_stats()
    assert stats["prefix_hits"] > 0
    assert stats["prefill_positions_skipped"] > 0
    assert _drained(eng_s) and _drained(eng_u)


def test_fully_covered_prompt_pays_one_position(params):
    """A duplicate prompt re-runs ONLY its final position and CoW-forks
    the page it rewrites; the indexed original keeps its bits."""
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, CFG.vocab_size, 2 * PS).astype(np.int32)
    eng = _engine(params, prefix_cache=True)
    first = dict(eng.run([Request(prompt=prompt.copy(), max_new=4)]))
    (idx_page,) = [p for p in eng.slots.prefix_index.match(prompt)][1:]
    before = eng.slots.cache["blocks"]["k"][:, idx_page].clone()
    dup = eng.run([Request(prompt=prompt.copy(), max_new=4,
                           arrival_t=float(eng.clock))])
    assert eng.slots.cow_copies >= 1
    assert eng.prefill_tokens_total == len(prompt) + 1
    assert torch.equal(eng.slots.cache["blocks"]["k"][:, idx_page], before)
    (a,), (b,) = first.values(), [dup[k] for k in dup if k not in first]
    np.testing.assert_array_equal(a.tokens[:4], b.tokens[:4])
    assert _drained(eng)


def test_cow_fork_never_corrupts_the_cached_prefix(params):
    """header+A, header+B, header+A: a CoW fork that failed to copy (or
    wrote through a shared page) would corrupt the third run."""
    rng = np.random.default_rng(21)
    header = rng.integers(1, CFG.vocab_size, 2 * PS).astype(np.int32)
    tails = [rng.integers(1, CFG.vocab_size, 5).astype(np.int32)
             for _ in range(2)]
    trace = [Request(prompt=np.concatenate([header, t]), max_new=6,
                     arrival_t=at)
             for t, at in ((tails[0], 0.0), (tails[1], 20.0),
                           (tails[0], 40.0))]
    eng = _engine(params, prefix_cache=True, n_slots=1)
    res = eng.run([r.clone() for r in trace])
    ref = _engine(params, prefix_cache=False, n_slots=1).run(
        [r.clone() for r in trace])
    for a, b in _pairs(res, ref):
        np.testing.assert_array_equal(a, b)
    assert _drained(eng)


# ---------------------------------------------------------------------------
# sharing x preemption: spills ship private pages only, resume re-pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta_spill", [False, True])
def test_spill_resume_with_shared_prefixes_token_exact(params, delta_spill):
    trace = _shared_trace(n=6)
    ref = _engine(params, prefix_cache=False).run([r.clone() for r in trace])
    eng = _engine(params, prefix_cache=True, n_slots=2)
    sched = PreemptiveScheduler(eng, preempt_mode="spill",
                                delta_spill=delta_spill)
    for r in sorted(trace, key=lambda r: r.arrival_t):
        sched.submit(r.clone())
    tick, spilled_private = 0, []
    while sched.has_work():
        tick += 1
        assert tick < 2000
        if tick % 7 == 0:
            for slot in list(eng.slots.active_slots()):
                st_ = eng.slots.states[slot]
                shared_before, n_pages = st_.shared_pages, len(st_.pages)
                sched.preempt(slot, "spill")
                entry = sched.swapped[st_.request.rid]
                assert len(entry.state.pages) == shared_before
                spilled_private.append(n_pages - shared_before)
        sched.step()
    assert sched.n_preemptions > 0 and any(n > 0 for n in spilled_private)
    for a, b in _pairs(eng.results, ref):
        np.testing.assert_array_equal(a, b)
    assert sched.n_resumes == sched.n_preemptions
    assert _drained(eng)


def test_store_eviction_redo_releases_pinned_prefix(params):
    trace = _shared_trace(n=5)
    ref = _engine(params, prefix_cache=False).run([r.clone() for r in trace])
    eng = _engine(params, prefix_cache=True, n_slots=2)
    sched = PreemptiveScheduler(eng, preempt_mode="spill", delta_spill=True,
                                spill_max_entries=1)
    for r in sorted(trace, key=lambda r: r.arrival_t):
        sched.submit(r.clone())
    tick = 0
    while sched.has_work():
        tick += 1
        assert tick < 3000
        if tick % 5 == 0:
            for slot in list(eng.slots.active_slots()):
                sched.preempt(slot, "spill")
        sched.step()
    for a, b in _pairs(eng.results, ref):
        np.testing.assert_array_equal(a, b)
    assert _drained(eng)


def test_evicted_spill_record_releases_its_pinned_prefix(params):
    """Driven step by step: two sequences over one indexed header spill,
    the second spill evicts the first's store record (one entry at most),
    and the first's redo drops the header references its swap entry
    pinned; both then finish token-exactly and the pool drains."""
    rng = np.random.default_rng(5)
    header = rng.integers(1, CFG.vocab_size, 2 * PS).astype(np.int32)
    trace = [Request(prompt=np.concatenate(
        [header, rng.integers(1, CFG.vocab_size, n).astype(np.int32)]),
        max_new=m) for n, m in ((3, 2), (5, 12), (7, 12))]
    ref = _engine(params, prefix_cache=False).run([r.clone() for r in trace])
    eng = _engine(params, prefix_cache=True, n_slots=2)
    sched = PreemptiveScheduler(eng, spill_max_entries=1)
    first, b, c = (r.clone() for r in trace)
    sched.submit(first)
    while sched.has_work():
        sched.step()
    hdr = eng.slots.prefix_index.match(header)
    assert len(hdr) == 2 and [eng.slots.allocator.refcount(p)
                              for p in hdr] == [1, 1]
    for r in (b, c):
        sched.submit(r)
    for _ in range(4):
        sched.step()
    slot_of = {eng.slots.states[s].request.rid: s
               for s in eng.slots.active_slots()}
    assert all(eng.slots.states[s].shared_pages == 2
               for s in slot_of.values())
    sched.preempt(slot_of[b.rid], "spill")
    assert [eng.slots.allocator.refcount(p) for p in hdr] == [3, 3]
    sched.preempt(slot_of[c.rid], "spill")     # evicts b's record
    assert sched.n_redo_from_prefill == 1 and b.rid not in sched.swapped
    assert [eng.slots.allocator.refcount(p) for p in hdr] == [2, 2]
    while sched.has_work():
        sched.step()
    for x, y in _pairs(eng.results, ref):
        np.testing.assert_array_equal(x, y)
    assert _drained(eng)


def test_admission_never_evicts_its_own_hit(params):
    """A pool short of pages whose only reclaimable pages are the very
    prefix a request hits: the request waits (its hit is pinned, not
    evicted from under it) and serves token-exactly once pages free.
    The reference's ``place_prefilling`` evicts before it attaches and
    raises ``PoolExhausted`` on this trace (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    A = rng.integers(1, CFG.vocab_size, 40).astype(np.int32)
    C = rng.integers(1, CFG.vocab_size, 20).astype(np.int32)
    B = np.concatenate([A[:32], rng.integers(1, CFG.vocab_size, 8)
                        .astype(np.int32)])
    trace = [Request(prompt=A, max_new=2, arrival_t=0.0),
             Request(prompt=C, max_new=14, arrival_t=3.0),
             Request(prompt=B, max_new=10, arrival_t=5.0)]
    eng = _engine(params, prefix_cache=True, pool_pages=6)
    res = eng.run([r.clone() for r in trace])
    ref = _engine(params, prefix_cache=False, pool_pages=6).run(
        [r.clone() for r in trace])
    for a, b in _pairs(res, ref):
        np.testing.assert_array_equal(a, b)
    assert eng.kv_cache_stats()["prefix_hits"] == 1
    assert _drained(eng)


def test_prefix_cache_requires_paged_layout(params):
    with pytest.raises(ValueError):
        ContinuousEngine(CFG, params, kv_layout="contiguous",
                         prefix_cache=True)


def test_clone_fresh_keeps_the_prefix_cache(params):
    eng = _engine(params, prefix_cache=True)
    assert eng.clone_fresh().slots.prefix_index is not None


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _bench_trace(B, vocab):
    """benchmarks/serving_throughput.py::_shared_prefix_trace (SP_*)."""
    rng = np.random.default_rng(11)
    headers = [rng.integers(1, vocab, 2 * PS).astype(np.int32)
               for _ in range(2)]
    t, out = 0.0, []
    for i in range(16):
        t += float(rng.exponential(1.0 / 0.6))
        tail = rng.integers(1, vocab, int(rng.integers(2, 9))).astype(
            np.int32)
        out.append(B.Request(prompt=np.concatenate([headers[i % 2], tail]),
                             max_new=int(rng.integers(2, 9)), arrival_t=t))
    return out


STAT_KEYS = ("prefix_hits", "prefix_misses", "prefix_pages_attached",
             "prefix_pages_evicted", "prefix_index_pages", "cow_page_copies",
             "prefill_positions_skipped", "peak_pages_in_use",
             "peak_pages_committed")


def test_shared_prefix_serving_matches_reference():
    """The bench's shared-prefix trace (plus a planted fully covered
    prompt) through both packages' engines with prefix_cache=True on the
    same bridged weights: the same tokens, prefill tokens and prefix,
    CoW and peak-page stats."""
    import jax
    from repro.config import get_reduced_config as j_reduced
    from repro.models import transformer as JT
    from repro.serving import batching as jB, engine as jE
    from repro_torch.bridge import params_from_numpy
    from repro_torch.serving import batching as tB
    jcfg = j_reduced("smollm-360m").with_(**F32)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=64)
    tp = params_from_numpy(jax.device_get(jp), CFG, device="cpu")
    out = {}
    for name, B, E, cfg, p in (("jax", jB, jE, jcfg, jp),
                               ("port", tB, ContinuousEngine, CFG, tp)):
        trace = _bench_trace(B, cfg.vocab_size)
        trace.append(B.Request(prompt=trace[0].prompt[:2 * PS].copy(),
                               max_new=5, arrival_t=trace[-1].arrival_t))
        eng = (E.ContinuousEngine if name == "jax" else E)(
            cfg, p, n_slots=4, max_seq=64, kv_layout="paged", page_size=PS,
            pool_pages=48, prefix_cache=True)
        res = eng.run(trace)
        toks = [np.asarray(res[r.rid].tokens) for r in trace]
        stats = eng.kv_cache_stats()
        eng.slots.prefix_index.clear()
        a = eng.slots.allocator
        out[name] = (toks, eng.prefill_tokens_total,
                     {k: stats[k] for k in STAT_KEYS},
                     a.in_use == 0 and a.n_live_refs() == 0)
    jt, jn, js, jd = out["jax"]
    tt, tn, ts, td = out["port"]
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a, b)
    assert (tn, ts) == (jn, js)
    assert ts["prefix_hits"] > 0 and ts["cow_page_copies"] >= 1
    assert td and jd


@given(st.integers(4, 24), st.lists(st.integers(0, 2 ** 31 - 1),
                                    min_size=1, max_size=50))
@settings(**SETTINGS)
def test_prefix_index_refcounts_exact_under_random_ops(n_pages, op_seeds):
    """Random admit (match, attach, evict)/index/finish/evict/clear traces
    drive the port's index and the reference's in lockstep, admission in
    the port's order (the hit is attached before anything is evicted):
    the same matches, evictions and stats after every op; refcounts equal
    a mirror model (a page lives while a table or the index holds it,
    the index holding at most one reference); an eviction frees only
    pages the index alone held, exactly ``min(n, reclaimable())``."""
    from repro.serving.paging import (BlockAllocator as JAlloc,
                                      PagePrefixIndex as JIndex)
    ps = 2
    a, ja = BlockAllocator(n_pages), JAlloc(n_pages)
    idx, jidx = PagePrefixIndex(a, ps), JIndex(ja, ps)
    rc = {}                            # mirror: page id -> references
    tables = []                        # (tokens, pages)

    def held(i):
        return sum(pages.count(i) for _, pages in tables)

    def evict(n):
        can = idx.reclaimable()
        freed = idx.evict(n)
        assert jidx.evict(n) == freed == min(n, can)
        gone = [i for i in rc if a.refcount(i) == 0]
        assert len(gone) == freed
        assert all(rc[i] == 1 and held(i) == 0 for i in gone)
        for i in gone:
            del rc[i]

    def attach(pages, n):
        for alloc in (a, ja):
            (alloc.share if n > 0 else alloc.release)(pages)
        for i in pages:
            rc[i] += n

    for seed in op_seeds:
        rng = np.random.default_rng(seed)
        op = int(rng.integers(0, 5))
        if op == 0:                                # admit over a prefix
            toks = rng.integers(1, 4, int(rng.integers(ps, 4 * ps + 1)))
            hit = idx.match(toks)
            assert jidx.match(toks) == hit
            need = len(toks) // ps - len(hit)
            attach(hit, 1)
            if a.available() < need:
                evict(need - a.available())
            if a.available() >= need:
                a.reserve(need)
                ja.reserve(need)
                new = a.alloc(need)
                assert ja.alloc(need) == new
                rc.update((i, 1) for i in new)
                tables.append((toks, list(hit) + new))
                idx.note_attach(len(hit))
                jidx.note_attach(len(hit))
            else:
                attach(hit, -1)                    # not admitted
        elif op == 1 and tables:                   # prefill done: index
            toks, pages = tables[int(rng.integers(len(tables)))]
            before = {i: a.refcount(i) for i in pages}
            added = idx.insert(toks, pages)
            assert jidx.insert(toks, pages) == added
            delta = {i: a.refcount(i) - before[i] for i in before}
            assert set(delta.values()) <= {0, 1}
            assert sum(delta.values()) == added
            for i, d in delta.items():
                rc[i] += d
        elif op == 2 and tables:                   # finish
            _, pages = tables.pop(int(rng.integers(len(tables))))
            attach(pages, -1)
            rc = {i: n for i, n in rc.items() if n}
        elif op == 3:                              # admission evicts
            evict(int(rng.integers(1, n_pages + 1)))
        elif op == 4 and not tables:               # end of life
            idx.clear()
            jidx.clear()
            assert a.in_use == 0 and a.n_live_refs() == 0
            rc = {}
        assert a.in_use == len(rc) == ja.in_use
        assert all(a.refcount(i) == n for i, n in rc.items())
        assert all(n - held(i) in (0, 1) for i, n in rc.items())
        assert a.n_live_refs() == sum(rc.values()) == ja.n_live_refs()
        assert idx.n_pages == sum(n - held(i) for i, n in rc.items())
        assert idx.stats() == jidx.stats()
        assert idx.reclaimable() == jidx.reclaimable()
    evict(a.n_pages)
    assert idx.reclaimable() == 0
