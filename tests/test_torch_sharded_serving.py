"""The port's mesh-sharded ``ContinuousEngine`` on the CPU: a 4-rank
gloo world (``repro_torch.launch.mesh.spawn``; the ranks run
tests/sharded_ranks.py, which imports no JAX) serves the reference
test's traces (tests/test_sharding.py: ``_serving_cfg``, ``_trace``,
``_ENGINE_KW``) on the reference's own weights, and a 2-rank mesh of
its first two ranks serves a config whose heads do not divide.

The reference's 4-device engine cannot run here (jax 0.9.0 raises a
``ShardingTypeError`` on its vocab-sharded embedding gather), so the
port's sharded runs are held against the reference's UNSHARDED engine
on the same trace (its own tests assert its sharded and unsharded runs
agree token for token) and against its rule functions on an
``AbstractMesh`` of (1, 4).  The world is spawned once for the module
and runs every scenario."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import sharded_ranks as R  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models import pspec as JPS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, spawn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402
from test_sharding import (_ENGINE_KW, _abstract_mesh,  # noqa: E402
                           _params_for, _serving_cfg, _trace)

N_RANKS = 4
ARCHS = [arch for arch, _ in R.SWEEP]
PER_DEVICE_KEYS = ("n_kv_shards", "kv_bytes_per_device",
                   "pages_in_use_per_device", "peak_pages_in_use_per_device",
                   "n_expert_shards", "experts_per_device", "mesh_axes",
                   "mesh_devices")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(res) -> dict:
    return {rid: np.asarray(r.tokens) for rid, r in res.items()}


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's params (numpy), its unsharded engine's
    tokens, ``kv_cache_stats`` and the overflow count of every capacity
    attempt that was re-run; and the preempt test's solo tokens."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        seen = []
        orig = JE._dynamic_capacity_prefill

        def recording(prefill_fn, cfg, n_tok):
            def run(cap):
                got = prefill_fn(cap)
                seen.append(int(got[1]))
                return got
            return orig(run, cfg, n_tok)
        mp.setattr(JE, "_dynamic_capacity_prefill", recording)
        for arch, n in R.SWEEP:
            cfg = _serving_cfg(arch)
            params = _params_for(cfg)
            del seen[:]
            eng = JE.ContinuousEngine(cfg, params, **_ENGINE_KW)
            res = eng.run(_trace(cfg, n))
            out[arch] = dict(params=jax.device_get(params),
                             tokens=_tokens(res),
                             stats=eng.kv_cache_stats(),
                             overflows=[a for a in seen if a])
    cfg = _serving_cfg("smollm-360m")
    solo = JE.ContinuousEngine(cfg, _params_for(cfg), **R.PREEMPT_KW).run(
        [JRequest(prompt=R.PREEMPT_PROMPT.copy(), max_new=6)])
    out["preempt_want"] = list(solo.values())[0].tokens
    return out


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded"))
    trees = {arch: reference[arch]["params"] for arch in ARCHS}
    pair = R.numpy_tree(T.init_params(R.replicated_cfg(), seed=1, device="cpu"))
    outs = spawn(R.run_world, N_RANKS, trees, pair, tmp, device="cpu",
                 threads=1,
                 timeout_s=300)
    return dict(ranks=outs, tmp=tmp, pair_tree=pair)


def _port_solo(arch, reference) -> dict:
    cfg = R.serving_cfg(arch)
    eng = ContinuousEngine(
        cfg, params_from_numpy(reference[arch]["params"], cfg, device="cpu"),
        **R.ENGINE_KW)
    return _tokens(eng.run(R.trace(cfg, dict(R.SWEEP)[arch])))


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid])


def test_configs_and_traces_are_the_reference_tests():
    for arch, n in R.SWEEP:
        j, t = _serving_cfg(arch), R.serving_cfg(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for a, b in zip(_trace(j, n), R.trace(t, n)):
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert (a.max_new, a.rid, a.arrival_t) == \
                (b.max_new, b.rid, b.arrival_t)
    assert R.ENGINE_KW == _ENGINE_KW


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_tokens_equal_the_unsharded_engines(arch, reference, world):
    """Every rank's tokens equal the reference's unsharded engine's and
    the port's one-rank engine's; the pools drain."""
    want = reference[arch]["tokens"]
    _assert_same(_port_solo(arch, reference), want)
    for out in world["ranks"]:
        _assert_same(out[arch]["tokens"], want)
        assert out[arch]["drained"]


def _reference_per_device(arch, stats0) -> dict:
    """What the reference's rules give for a (1, 4) mesh: the pool's
    per-device bytes and shard factor from ``paged_cache_pspecs``, the
    expert split from ``shard_count`` under the serving map; the page
    ledger is the unsharded run's."""
    cfg = _serving_cfg(arch)
    mesh = _abstract_mesh((1, N_RANKS), ("data", "model"))
    pool = jax.eval_shape(lambda: JT.init_paged_cache(
        cfg, stats0["pool_pages"] + 1, stats0["page_size"]))
    per_dev, n_shards = 0, 1
    with JPS.mesh_rules(mesh, JSH.SERVING_LOGICAL_MAP):
        for path, leaf in jax.tree_util.tree_flatten_with_path(pool)[0]:
            spec = JPS.pspec_for(leaf.shape, JSH.paged_cache_logical_axes(
                cfg, path, leaf))
            f = int(np.prod([mesh.shape[a] for e in spec if e is not None
                             for a in (e if isinstance(e, tuple) else (e,))]))
            per_dev += leaf.size // f * leaf.dtype.itemsize
            n_shards = max(n_shards, f)
        E = cfg.moe.n_experts if cfg.moe is not None else 0
        n_exp = JPS.shard_count("expert", E) if E else 1
    return dict(n_kv_shards=n_shards, kv_bytes_per_device=per_dev,
                pages_in_use_per_device=stats0["pages_in_use_per_device"],
                peak_pages_in_use_per_device=stats0["peak_pages_in_use"],
                n_expert_shards=n_exp,
                experts_per_device=E // n_exp if E else 0,
                mesh_axes={"data": 1, "model": N_RANKS},
                mesh_devices=N_RANKS)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_stats_follow_the_reference_rules(arch, reference, world):
    ref = reference[arch]
    want = _reference_per_device(arch, ref["stats"])
    for out in world["ranks"]:
        s = out[arch]["stats"]
        assert s.keys() == ref["stats"].keys()
        assert {k: s[k] for k in PER_DEVICE_KEYS} == want
        assert s["n_kv_shards"] == N_RANKS
        assert s["kv_bytes_per_device"] * N_RANKS == s["kv_cache_bytes"] \
            == ref["stats"]["kv_cache_bytes"]
        assert out[arch]["local_bytes"] == s["kv_bytes_per_device"]
        assert s["peak_pages_in_use_per_device"] == s["peak_pages_in_use"] \
            == ref["stats"]["peak_pages_in_use"]
        assert out[arch]["overflows"] == ref["overflows"]
        if arch != "smollm-360m":
            E = _serving_cfg(arch).moe.n_experts
            assert s["experts_per_device"] * s["n_expert_shards"] == E
            assert s["n_expert_shards"] == N_RANKS


def test_sharded_preempt_spill_resume_and_checkpoint(reference, world):
    """Preempt -> spill -> resume and a mid-flight checkpoint restored
    into ``clone_fresh()`` on the 4-rank engine: token-exact with the
    reference's solo run; an unsharded engine refuses the checkpoint."""
    want = reference["preempt_want"]
    for out in world["ranks"]:
        p = out["preempt"]
        np.testing.assert_array_equal(p["preempted"], want)
        assert p["n_preemptions"] == 1 and p["preempt_drained"]
        np.testing.assert_array_equal(p["restored"], want)
        assert p["clone_keeps_mesh"] and p["ckpt_bytes"] > 0
    cfg = R.serving_cfg("smollm-360m")
    params = params_from_numpy(reference["smollm-360m"]["params"], cfg,
                               device="cpu")
    with pytest.raises(RuntimeError, match="mesh"):
        PreemptiveScheduler(ContinuousEngine(cfg, params, **R.PREEMPT_KW)) \
            .restore(f"{world['tmp']}/sharded.ckpt")


def test_two_ranks_replicate_what_does_not_divide(world):
    """A 2-rank mesh at 15/5 heads: attention and the pool replicate
    (``n_kv_shards`` 1), the vocab and d_ff split; the tokens are the
    one-rank engine's."""
    cfg = R.replicated_cfg()
    eng = ContinuousEngine(cfg, params_from_numpy(world["pair_tree"], cfg,
                                                  device="cpu"),
                           **R.ENGINE_KW)
    want = _tokens(eng.run(R.trace(cfg)))
    for out in world["ranks"][:2]:
        s = out["pair"]["stats"]
        _assert_same(out["pair"]["tokens"], want)
        assert s["n_kv_shards"] == 1
        assert s["kv_bytes_per_device"] == s["kv_cache_bytes"] \
            == out["pair"]["local_bytes"]
        assert s["mesh_axes"] == {"data": 1, "model": 2}
    assert all("pair" not in out for out in world["ranks"][2:])


def test_mesh_refuses_the_contiguous_layout():
    cfg = R.serving_cfg("smollm-360m")
    params = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ContinuousEngine(cfg, params, mesh=make_local_mesh(),
                         kv_layout="contiguous", **R.ENGINE_KW)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_unsharded_stats_match_the_reference(layout, reference):
    """The port's unsharded engines return the reference's
    ``kv_cache_stats`` keys with equal values (the per-device and mesh
    keys among them): paged after the sweep's trace, contiguous after
    the same trace on the port (the contiguous stats are the fixed
    cache's, so the reference's engine is read unrun)."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg = _serving_cfg(arch), R.serving_cfg(arch)
    kw = dict(_ENGINE_KW, kv_layout=layout)
    if layout == "paged":
        want = reference[arch]["stats"]
    else:
        want = JE.ContinuousEngine(jcfg, _params_for(jcfg),
                                   **kw).kv_cache_stats()
    teng = ContinuousEngine(tcfg, params_from_numpy(
        reference[arch]["params"], tcfg, device="cpu"), **kw)
    teng.run(R.trace(tcfg, dict(R.SWEEP)[arch]))
    assert teng.kv_cache_stats() == want
