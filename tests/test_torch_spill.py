"""The port's spill path against the JAX package's: the paged-pool
snapshot and graft (``extract_paged_cache`` / ``graft_paged_cache``) on
the same numpy pool, bit for bit in fp32 and bf16, and the
``DeltaSpillStore`` driven in lockstep with the reference store through
random grow/dirty/spill cycles (a twin of
``tests/test_property.py::test_delta_store_merge_matches_full_reference``):
the same records, watermarks, epochs, byte counts, CRC32 values and
stats, with and without the zstd codec and under LRU caps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import assume, given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.faults import FaultInjector as JInjector  # noqa: E402
from repro.core.faults import FaultPlan as JPlan  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import paging as jpaging  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.core.faults import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import paging  # noqa: E402
from repro_torch.serving.paging import (DeltaSpillStore,  # noqa: E402
                                        SpillCorruption)

HAS_ZSTD = paging.zstd is not None
CODECS = [None, "zstd"] if HAS_ZSTD else [None]


def _pool(dtype, seed=0, L=2, n_pages=9, ps=4, Hkv=2, D=3):
    rng = np.random.default_rng(seed)
    shape = (L, n_pages, ps, Hkv, D)
    return {"blocks": {k: rng.standard_normal(shape).astype(np.float32)
                       .astype(dtype) for k in ("k", "v")}}


def _as_torch(tree):
    return {n: {k: tensor_from_numpy(a, "cpu") for k, a in d.items()}
            for n, d in tree.items()}


def _as_numpy(tree):
    def host(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()
    return {n: {k: host(t) for k, t in d.items()} for n, d in tree.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("since", [0, 2])
def test_extract_and_graft_match_reference(dtype, since):
    pool = _pool(dtype)
    pages = [7, 2, 5, 1]
    want = jax.device_get(JT.extract_paged_cache(
        jax.tree.map(jnp.asarray, pool), jnp.asarray(pages, jnp.int32),
        since=since))
    got = _as_numpy(T.extract_paged_cache(_as_torch(pool), pages,
                                          since=since))
    for k in ("k", "v"):
        assert got["blocks"][k].shape == (2, 1, (4 - since) * 4, 2, 3)
        np.testing.assert_array_equal(_bits(got["blocks"][k]),
                                      _bits(want["blocks"][k]))
    # graft a short prefix (padded) and a whole snapshot (round trip)
    for snap in (want, jax.tree.map(lambda a: a[:, :, :5], want)):
        dest = [3, 8, 6, 4]
        jgot = jax.device_get(JT.graft_paged_cache(
            jax.tree.map(jnp.asarray, pool), jax.tree.map(jnp.asarray, snap),
            jnp.asarray(dest, jnp.int32), since=since))
        tpool = _as_torch(pool)
        out = T.graft_paged_cache(tpool, _as_torch(snap), dest, since=since)
        assert out is tpool                          # in place
        for k in ("k", "v"):
            np.testing.assert_array_equal(_bits(_as_numpy(out)["blocks"][k]),
                                          _bits(jgot["blocks"][k]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extract_graft_round_trip_is_bit_exact(dtype):
    pool = _as_torch(_pool(np.float32, seed=1))
    pool = {"blocks": {k: t.to(dtype) for k, t in pool["blocks"].items()}}
    snap = T.extract_paged_cache(pool, [5, 1, 8])
    fresh = {"blocks": {k: torch.zeros_like(t)
                        for k, t in pool["blocks"].items()}}
    T.graft_paged_cache(fresh, snap, [2, 3, 4])
    for k in ("k", "v"):
        assert torch.equal(fresh["blocks"][k][:, [2, 3, 4]],
                           pool["blocks"][k][:, [5, 1, 8]])


def _record_view(store, rid):
    rec = store.record(rid)
    return (rec.synced_pages, rec.epoch, rec.nbytes, rec.crc)


@given(st.sampled_from([2, 4, 8]),
       st.lists(st.tuples(st.integers(0, 2), st.integers(1, 3)),
                min_size=1, max_size=8),
       st.integers(0, 2 ** 31 - 1), st.sampled_from(CODECS),
       st.sampled_from([None, 2]), st.booleans())
@settings(max_examples=25, deadline=None)
def test_delta_store_matches_reference(ps, ops_, seed, codec, max_entries,
                                       bf16):
    """Random grow/dirty/spill cycles over up to three sequences, merged
    into both stores: every merged snapshot equals the mirror bit for
    bit, and the records (watermark, epoch, host bytes, CRC32), the
    evictions and ``stats()`` are the reference store's after every
    merge; a snapshot of every live record reads back the mirror.  (The
    reference's zstd codec cannot unpack bf16, whose numpy dtype string
    is a void type: that pair is checked on the port alone, below.)"""
    assume(not (bf16 and codec == "zstd"))
    rng = np.random.default_rng(seed)
    np_dt = jnp.bfloat16 if bf16 else np.float32
    a = DeltaSpillStore(ps, codec=codec, max_entries=max_entries)
    j = jpaging.DeltaSpillStore(ps, codec=codec, max_entries=max_entries)
    mirror, synced = {}, {}
    for rid, g in ops_:
        if rid not in mirror or rid not in a:          # new or evicted
            mirror[rid] = {k: np.zeros((2, 1, 0, 3), np_dt)
                           for k in ("k", "v")}
            synced[rid] = 0
        w = int(rng.integers(0, synced[rid] + 1))
        total = mirror[rid]["k"].shape[2] // ps + g
        grown = {}
        for k, arr in mirror[rid].items():
            arr = np.concatenate([arr, np.zeros((2, 1, g * ps, 3), np_dt)],
                                 axis=2)
            arr[:, :, w * ps:] = rng.standard_normal(
                (2, 1, (total - w) * ps, 3)).astype(np_dt)
            grown[k] = arr
        mirror[rid] = grown
        delta = {k: arr[:, :, w * ps:] for k, arr in grown.items()}
        jm = j.merge(rid, delta, w, total)
        tm = a.merge(rid, {k: tensor_from_numpy(v, "cpu")
                           for k, v in delta.items()}, w, total)
        synced[rid] = total
        for k in ("k", "v"):
            np.testing.assert_array_equal(_bits(_as_numpy({"x": tm})["x"][k]),
                                          _bits(jm[k]))
        assert a.take_evicted() == j.take_evicted()
        assert sorted(a._by_rid) == sorted(j._by_rid)
        for r in a._by_rid:
            assert _record_view(a, r) == _record_view(j, r)
        assert a.synced_pages(rid) == j.synced_pages(rid) == total
        assert a.stats() == j.stats() and a.counters() == j.counters()
    for r in list(a._by_rid):
        snap = _as_numpy({"x": a.snapshot(r)})["x"]
        for k in ("k", "v"):
            np.testing.assert_array_equal(_bits(snap[k]), _bits(mirror[r][k]))
        a.drop(r)
        j.drop(r)
    assert len(a) == 0 and a.stats() == j.stats()


def _small(seed):
    rng = np.random.default_rng(seed)
    return {"k": torch.from_numpy(rng.standard_normal((2, 1, 8, 3))
                                  .astype(np.float32)),
            "v": torch.from_numpy(rng.standard_normal((2, 1, 8, 3))
                                  .astype(np.float32))}


@pytest.mark.parametrize("codec", CODECS)
def test_corruption_detected_at_snapshot_and_at_merge(codec):
    s = DeltaSpillStore(4, codec=codec)
    s.merge(1, _small(0), 0, 2)
    s.merge(2, _small(1), 0, 2)
    for rid in (1, 2):                       # flip one byte of each record
        rec = s.record(rid)
        if codec is None:
            rec.kv["k"].view(-1).view(torch.uint8)[5] ^= 0x01
        else:
            blob, dt, shape = rec.kv[1][0]
            rec.kv[1][0] = (bytes([blob[0] ^ 1]) + blob[1:], dt, shape)
    with pytest.raises(SpillCorruption, match="at snapshot"):
        s.snapshot(1)
    with pytest.raises(SpillCorruption, match="at merge"):
        s.merge(2, None, 2, 2)
    assert 1 not in s and 2 not in s and s.n_corruptions_detected == 2
    assert s.stored_bytes == 0


@pytest.mark.parametrize("codec", CODECS)
def test_injected_spill_corruption_matches_reference(codec):
    """Every 2nd merge lands corrupted in both stores, at the same seeded
    offset: the same CRC mismatches, detections and injector state."""
    plan = dict(seed=4, spill_corrupt_every=2)
    a = DeltaSpillStore(4, codec=codec, injector=FaultInjector(
        FaultPlan(**plan)))
    j = jpaging.DeltaSpillStore(4, codec=codec, injector=JInjector(
        JPlan(**plan)))
    for rid in range(4):
        kv = _small(rid)
        a.merge(rid, kv, 0, 2)
        j.merge(rid, {k: v.numpy() for k, v in kv.items()}, 0, 2)
    for rid in range(4):
        outcomes = []
        for s in (a, j):
            try:
                s.snapshot(rid)
                outcomes.append("ok")
            except (SpillCorruption, jpaging.SpillCorruption):
                outcomes.append("corrupt")
        assert outcomes[0] == outcomes[1] == ("corrupt" if rid % 2 else "ok")
    assert a.stats() == j.stats()
    assert a.injector.state() == j.injector.state()


@pytest.mark.skipif(not HAS_ZSTD, reason="zstandard is not installed")
def test_zstd_codec_compresses_and_round_trips():
    s = DeltaSpillStore(4, codec="zstd")
    kv = {"k": torch.zeros((2, 1, 64, 3)), "v": torch.ones((2, 1, 64, 3))}
    merged = s.merge(9, kv, 0, 16)
    assert merged is kv and s.record(9).nbytes < 2 * kv["k"].numel() * 4
    assert s.bytes_compressed == s.record(9).nbytes
    back = s.snapshot(9)
    assert all(torch.equal(back[k], kv[k]) for k in kv)
    bf = {k: torch.randn((2, 1, 8, 3)).to(torch.bfloat16) for k in "kv"}
    s.merge(10, bf, 0, 2)
    delta = {k: torch.randn((2, 1, 4, 3)).to(torch.bfloat16) for k in "kv"}
    merged = s.merge(10, delta, 1, 3)
    back = s.snapshot(10)
    for k in "kv":
        assert back[k].dtype == torch.bfloat16
        assert torch.equal(back[k].view(torch.int16),
                           merged[k].view(torch.int16))
        assert torch.equal(back[k][:, :, 4:].view(torch.int16),
                           delta[k].view(torch.int16))


def test_zstd_codec_raises_without_zstandard(monkeypatch):
    monkeypatch.setattr(paging, "zstd", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        DeltaSpillStore(4, codec="zstd")
    with pytest.raises(ValueError, match="unknown spill codec"):
        DeltaSpillStore(4, codec="lz4")
