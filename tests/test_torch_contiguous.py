"""The port's contiguous serving paths against the JAX package's, and the
reference's internal invariants of those paths held on the port.

Parity (same numpy-seeded inputs, JAX params bridged into the port, fp32
on the CPU): ``ServingEngine.generate`` (tokens identical, prompt and
final logits atol 1e-4) and ``ContinuousEngine(kv_layout="contiguous")``
(tokens, clock, finish order and step stamps identical, final logits
atol 1e-4).  Logits differ in the last bits because XLA and PyTorch sum
in other orders; tokens may not differ at all.

Twins, on the port alone: tests/test_continuous_batching.py's
``test_continuous_matches_fixed_slot_engine``,
``test_decode_step_vector_pos_matches_scalar`` and
``test_graft_slot_cache_writes_only_target_slot``,
tests/test_paged_kv.py's ``test_paged_matches_contiguous_trace`` and
``test_paged_pool_uses_less_memory_than_contiguous``, and a
``SlotManager`` snapshot -> detach -> restore round trip."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.serving.batching import poisson_trace as j_trace  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request, poisson_trace  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCHS = ["smollm-360m", "tiansuan_pair"]     # reduced: tiansuan ONBOARD


def _pair(arch, seed=0):
    jcfg, tcfg = j_reduced(arch).with_(**F32), t_reduced(arch).with_(**F32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg, max_seq=64)
    return jcfg, tcfg, jparams, params_from_numpy(jax.device_get(jparams),
                                                  tcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_generate_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, tcfg.vocab_size, (3, 13)).astype(np.int32)
    want = JServing(jcfg, jparams, max_seq=64).generate(prompts, max_new=7)
    got = ServingEngine(tcfg, tparams, max_seq=64).generate(prompts,
                                                            max_new=7)
    assert got.tokens.shape == (3, 7) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prompt_logits, want.prompt_logits,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.logits_last, want.logits_last, atol=1e-4,
                               rtol=0)


def test_contiguous_engine_matches_jax():
    jcfg, tcfg, jparams, tparams = _pair("tiansuan_pair")
    kw = dict(n_slots=3, max_seq=64, kv_layout="contiguous")
    trace = dict(rate=0.6, prompt_lens=(3, 30), max_new=(1, 9),
                 vocab_size=tcfg.vocab_size, seed=5)
    jreqs, treqs = j_trace(7, **trace), poisson_trace(7, **trace)
    jeng, teng = JEngine(jcfg, jparams, **kw), ContinuousEngine(tcfg, tparams,
                                                                **kw)
    jres, tres = jeng.run(jreqs), teng.run(treqs)
    assert teng.kv_layout == "contiguous"
    assert teng.clock == jeng.clock
    t_idx = {r.rid: i for i, r in enumerate(treqs)}
    j_idx = {r.rid: i for i, r in enumerate(jreqs)}
    assert [t_idx[rid] for rid in teng.finish_order] == \
        [j_idx[rid] for rid in jeng.finish_order]
    for jr, tr in zip(jreqs, treqs):
        a, b = jres[jr.rid], tres[tr.rid]
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert (b.admitted_step, b.first_token_step, b.finished_step) == \
            (a.admitted_step, a.first_token_step, a.finished_step)
        np.testing.assert_allclose(b.logits_last, a.logits_last, atol=1e-4,
                                   rtol=0)
    assert teng.kv_cache_stats()["kv_cache_bytes"] == \
        jeng.kv_cache_stats()["kv_cache_bytes"]


# ---------------------------------------------------------------------------
# twins of the reference's invariants, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cfg():
    return t_reduced("smollm-360m").with_(**F32)


@pytest.fixture(scope="module")
def params(cfg):
    return T.init_params(cfg, seed=0, device="cpu")


def _clone(reqs):
    return [r.clone() for r in reqs]


def _tokens_by_arrival(reqs, results):
    """Results in submission order (clones get fresh rids)."""
    return [results[r.rid].tokens for r in reqs]


@pytest.mark.parametrize("kv_layout", ["paged", "contiguous"])
def test_continuous_matches_fixed_slot_engine(cfg, params, kv_layout):
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, cfg.vocab_size, 11).astype(np.int32)
    want = ServingEngine(cfg, params, max_seq=64).generate(
        prompt[None], max_new=6).tokens[0]
    eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                           kv_layout=kv_layout)
    got = eng.run([Request(prompt=prompt, max_new=6)])
    np.testing.assert_array_equal(list(got.values())[0].tokens, want)


def test_serving_engine_sampling_is_seeded(cfg, params):
    """greedy=False draws each token from a torch.Generator seeded by
    ``seed``: the same seed gives the same tokens, another seed others."""
    eng = ServingEngine(cfg, params, max_seq=64)
    prompts = np.arange(2, 26, dtype=np.int32).reshape(2, 12)
    a, b, c = (eng.generate(prompts, max_new=12, greedy=False, seed=s)
               for s in (1, 1, 2))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, c.tokens)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab_size)).all()
    greedy = eng.generate(prompts, max_new=12)
    np.testing.assert_array_equal(a.prompt_logits, greedy.prompt_logits)


def test_decode_step_vector_pos_matches_scalar(cfg, params):
    """With every slot at the same depth, the per-slot path agrees with
    the scalar path bit for bit."""
    B, S = 3, 8
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32))
    _, _, pc = T.forward(params, cfg, {"tokens": toks}, return_cache=True)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))
                           .astype(np.int32))
    lo_s, _ = T.decode_step(params, cfg, T.graft_slot_cache(
        T.init_cache(cfg, B, 32, device="cpu"), pc, 0), nxt, S)
    lo_v, _ = T.decode_step(params, cfg, T.graft_slot_cache(
        T.init_cache(cfg, B, 32, device="cpu"), pc, 0), nxt,
        torch.full((B,), S, dtype=torch.int32))
    assert torch.equal(lo_s, lo_v)


def test_graft_slot_cache_writes_only_target_slot(cfg, params):
    big = T.init_cache(cfg, 3, 32, device="cpu")
    before = {k: t.clone() for k, t in big["blocks"].items()}
    toks = torch.from_numpy(np.arange(1, 9, dtype=np.int32)[None])
    _, _, small = T.forward(params, cfg, {"tokens": toks}, return_cache=True)
    out = T.graft_slot_cache(big, small, 1)
    for k in ("k", "v"):
        o, b, s = out["blocks"][k], before[k], small["blocks"][k]
        assert torch.equal(o[:, 0], b[:, 0]) and torch.equal(o[:, 2], b[:, 2])
        assert torch.equal(o[:, 1, :s.shape[2]], s[:, 0])
        assert torch.equal(o[:, 1, s.shape[2]:], b[:, 1, s.shape[2]:])


def test_paged_matches_contiguous_trace(cfg, params):
    trace = poisson_trace(10, rate=0.7, prompt_lens=(3, 14), max_new=(1, 10),
                          vocab_size=cfg.vocab_size, seed=11)
    cont = ContinuousEngine(cfg, params, n_slots=3, max_seq=64,
                            kv_layout="contiguous")
    paged = ContinuousEngine(cfg, params, n_slots=3, max_seq=64,
                             kv_layout="paged")
    creqs, preqs = _clone(trace), _clone(trace)
    cres, pres = cont.run(creqs), paged.run(preqs)
    assert len(cres) == len(pres) == len(trace)
    for want, got in zip(_tokens_by_arrival(creqs, cres),
                         _tokens_by_arrival(preqs, pres)):
        np.testing.assert_array_equal(got, want)


def test_paged_pool_uses_less_memory_than_contiguous(cfg, params):
    kw = dict(n_slots=4, max_seq=64)
    paged = ContinuousEngine(cfg, params, kv_layout="paged", **kw)
    cont = ContinuousEngine(cfg, params, kv_layout="contiguous", **kw)
    pb = paged.kv_cache_stats()["kv_cache_bytes"]
    cb = cont.kv_cache_stats()["kv_cache_bytes"]
    assert cont.kv_cache_stats()["kv_layout"] == "contiguous"
    assert cb == 2 * cfg.n_layers * 4 * 64 * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 4
    assert pb < cb, (pb, cb)


def test_slot_manager_snapshot_detach_restore_roundtrip(cfg, params):
    """A decoding sequence snapshotted and detached, its row clobbered
    (a reused slot), then restored: the row comes back bit for bit and
    the sequence finishes with the tokens of an undisturbed run."""
    prompt = np.arange(3, 17, dtype=np.int32)
    solo = ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                            kv_layout="contiguous")
    want = list(solo.run([Request(prompt=prompt, max_new=8)]).values())[0]

    eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                           kv_layout="contiguous")
    req = Request(prompt=prompt, max_new=8)
    eng.submit(req)
    eng.step()
    eng.step()
    slots = eng.slots
    kv = slots.snapshot(0)
    assert all(t.device.type == "cpu" and t.shape[1] == 1
               for d in kv.values() for t in d.values())
    st = slots.detach(0)
    assert slots.states[0] is None and st.request is req
    for t in slots.cache["blocks"].values():
        t[:, 0] = torch.randn(t[:, 0].shape)
    slots.restore(0, st, kv)
    for k, t in slots.cache["blocks"].items():
        assert torch.equal(t[:, :1], kv["blocks"][k])
    with pytest.raises(RuntimeError):
        slots.restore(0, st, kv)                  # occupied
    with pytest.raises(RuntimeError):
        slots.restore(1, st)                      # no snapshot
    got = eng.run()
    np.testing.assert_array_equal(got[req.rid].tokens, want.tokens)
