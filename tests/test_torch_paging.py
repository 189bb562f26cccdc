"""Twins of the reference's allocator and gate property tests
(tests/test_property.py) on the port: the port's ``BlockAllocator`` is
driven in lockstep with the JAX package's through random op traces and
must hand out the same pages with the same ledger; the port's gate keeps
the reference's metric ranges and threshold monotonicity; the engine
keeps the unified step's per-tick token budget."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving.paging import BlockAllocator as JAlloc  # noqa: E402
from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.core.gating import ConfidenceGate  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import poisson_trace  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.paging import (BlockAllocator,  # noqa: E402
                                        PoolExhausted, default_pool_pages,
                                        pages_for)

SETTINGS = dict(max_examples=30, deadline=None)


def _ledger(a):
    return (a.in_use, a.reserved, a.available(), list(a._free),
            dict(a._refcount), a.peak_in_use, a.peak_committed)


@given(st.integers(2, 24), st.lists(st.integers(0, 2 ** 31 - 1),
                                    min_size=1, max_size=50))
@settings(**SETTINGS)
def test_allocator_matches_reference_under_random_ops(n_pages, op_seeds):
    """Reserve/alloc/share/release traces applied to both allocators:
    the same page ids come out and the ledgers agree after every op; a
    full drain restores the pool and a second release raises."""
    a, j = BlockAllocator(n_pages), JAlloc(n_pages)
    tables = []                            # (pages, outstanding reservation)
    for seed in op_seeds:
        rng = np.random.default_rng(seed)
        op = rng.integers(0, 4)
        if op == 0 and a.available() > 0:              # admit
            budget = int(rng.integers(1, a.available() + 1))
            first = int(rng.integers(1, budget + 1))
            a.reserve(budget)
            j.reserve(budget)
            pages = a.alloc(first)
            assert j.alloc(first) == pages
            tables.append((pages, budget - first))
        elif op == 1 and tables:                       # grow one page
            i = int(rng.integers(len(tables)))
            pages, rest = tables[i]
            if rest > 0:
                new = a.alloc(1)
                assert j.alloc(1) == new
                tables[i] = (pages + new, rest - 1)
        elif op == 2 and tables:                       # share a prefix
            src = tables[int(rng.integers(len(tables)))][0]
            if src:
                shared = src[:int(rng.integers(1, len(src) + 1))]
                a.share(shared)
                j.share(shared)
                tables.append((list(shared), 0))
        elif op == 3 and tables:                       # evict
            pages, rest = tables.pop(int(rng.integers(len(tables))))
            a.release(pages, unreserve=rest)
            j.release(pages, unreserve=rest)
        assert _ledger(a) == _ledger(j)
    for pages, rest in tables:
        a.release(pages, unreserve=rest)
    assert a.in_use == 0 and a.reserved == 0 and a.available() == n_pages
    with pytest.raises(PoolExhausted):
        a.release([1])


def test_pool_sizing_matches_reference():
    from repro.serving import paging as jp
    for n_slots, max_seq, ps in [(8, 2048, 16), (3, 64, 16), (1, 100, 8)]:
        assert default_pool_pages(n_slots, max_seq, ps) == \
            jp.default_pool_pages(n_slots, max_seq, ps)
        assert pages_for(max_seq, ps) == jp.pages_for(max_seq, ps)
    assert default_pool_pages(8, 2048, 16) == 768


@given(st.integers(1, 8), st.integers(2, 64), st.floats(0.1, 10.0))
@settings(**SETTINGS)
def test_confidence_metric_ranges(B, V, scale):
    rng = np.random.default_rng(B * 100 + V)
    x = torch.from_numpy((rng.standard_normal((B, V)) * scale)
                         .astype(np.float32))
    m = ref.confidence_gate_ref(x)
    assert bool(((m["max_prob"] > 0) & (m["max_prob"] <= 1 + 1e-6)).all())
    assert bool(((m["entropy"] >= -1e-5)
                 & (m["entropy"] <= np.log(V) + 1e-4)).all())
    assert bool(((m["margin"] >= -1e-6) & (m["margin"] <= 1 + 1e-6)).all())
    assert bool(((m["argmax"] >= 0) & (m["argmax"] < V)).all())


@given(st.integers(1, 40), st.integers(2, 30),
       st.floats(0.0, 1.0), st.floats(0.0, 1.0))
@settings(**SETTINGS)
def test_gate_threshold_monotone(B, V, t_lo, t_hi):
    """A higher threshold never escalates fewer items, and the escalated
    sets are nested."""
    t_lo, t_hi = min(t_lo, t_hi), max(t_lo, t_hi)
    rng = np.random.default_rng(B * V)
    x = torch.from_numpy((rng.standard_normal((B, V)) * 3)
                         .astype(np.float32))
    lo = ConfidenceGate("max_prob", t_lo).decide(x)["escalate"]
    hi = ConfidenceGate("max_prob", t_hi).decide(x)["escalate"]
    assert int(hi.sum()) >= int(lo.sum())
    assert bool((~lo | hi).all())


def test_engine_tick_budget_and_drain():
    """Every tick spends at most the prefill budget and decodes at most
    one token per slot; the pool drains when the trace is served."""
    cfg = get_reduced_config("tiansuan_pair")
    eng = ContinuousEngine.init(cfg, device="cpu", n_slots=2, max_seq=64,
                                prefill_budget_tokens=8)
    reqs = poisson_trace(5, prompt_lens=(3, 30), max_new=(1, 6),
                         vocab_size=cfg.vocab_size, seed=1)
    for r in reqs:
        eng.submit(r)
    while len(eng.queue) or eng.slots.any_active():
        eng.step()
        assert eng.last_tick_prefill_tokens <= 8
        assert eng.last_tick_decode_tokens <= 2
    assert [len(eng.results[r.rid].tokens) for r in reqs] == \
        [r.max_new for r in reqs]
    a = eng.slots.allocator
    assert a.in_use == 0 and a.reserved == 0 and a.n_live_refs() == 0


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(mesh=make_local_mesh(),
                                     kv_layout="contiguous"),
                                dict(kv_layout="contiguous",
                                     prefix_cache=True)])
def test_engine_refuses_what_is_not_ported(kw):
    """Mesh serving and the prefix cache are ported, on the paged layout
    only: a mesh or a prefix cache on a contiguous one raises
    ValueError, as the reference does; the vlm family is refused by the
    continuous engine, as in the reference."""
    cfg = get_reduced_config("tiansuan_pair")
    params = T.init_params(cfg, device="cpu")
    if kw.get("kv_layout") == "contiguous":
        with pytest.raises(ValueError, match="paged"):
            ContinuousEngine(cfg, params, max_seq=64, **kw)
    else:
        eng = ContinuousEngine(cfg, params, max_seq=64, **kw)
        assert eng.slots.prefix_index is not None
    with pytest.raises(NotImplementedError, match="does not serve"):
        ContinuousEngine(cfg.with_(family="vlm"), params, max_seq=64)
