"""The port's xLSTM family (``family="ssm"``: ``models/xlstm.py`` and the
ssm branches of ``models/transformer.py``, the engines on the contiguous
``SlotManager``) against the JAX package's.

Parity (same numpy-seeded inputs, JAX params and caches bridged into the
port, fp32 on the CPU, reduced xlstm-1.3b at n_layers=4, i.e. two units
of one mLSTM and one sLSTM block): ``mlstm_chunked`` over two chunks,
from a zero and from a carried state; each block's full-sequence
forward (with its state) and decode step; ``forward`` logits and cache;
decode steps from a bridged cache; ``ServingEngine.generate`` and
``ContinuousEngine`` greedy tokens.

Twins, on the port alone: tests/test_models.py's prefill + decode ==
forward over S + 1 tokens, tests/test_continuous_batching.py's
mid-flight join == solo run, the batch axis of every cache leaf in a
graft and an extract (axis 2 of ``mlstm_units``, axis 1 of
``slstm_units``), and the bridge's check of every leaf.

Tolerance: atol 1e-4 on logits, hidden states and states (the same fp32
arithmetic, sums in another order by XLA and by PyTorch's CPU kernels;
seen ~6e-6 on logits); decode against forward atol 2e-5, as the hybrid
twin.  Tokens may not differ at all."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

ATOL = 1e-4
KW = dict(param_dtype="float32", activation_dtype="float32", n_layers=4)
MAX_SEQ = 96
# (len, max_new, arrival): exact-length admission, prompts up to the
# mLSTM's one-chunk limit here
TRACE = [(5, 6, 0.0), (40, 4, 0.0), (17, 5, 1.0), (64, 3, 2.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_reduced("xlstm-1.3b").with_(**KW), \
        t_reduced("xlstm-1.3b").with_(**KW)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg, max_seq=MAX_SEQ))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)) \
        .astype(np.int32)


def _close_tree(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _close_tree(got[k], v)
        else:
            assert tuple(got[k].shape) == v.shape, k
            _close(got[k], v)


def test_mlstm_chunked_matches_jax_over_two_chunks_and_a_carried_state():
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 64, 2, 16
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (q, k, v, ig, fg)]
    targs = [torch.from_numpy(a) for a in (q, k, v, ig, fg)]
    chunked = jax.jit(JX.mlstm_chunked, static_argnames="chunk")
    wh, wst = chunked(*jargs, chunk=32)
    gh, gst = X.mlstm_chunked(*targs, chunk=32)
    _close(gh, wh)
    for g, w in zip(gst, wst):
        _close(g, w)
    # a second call from the first one's state, at one chunk
    wh2, wst2 = chunked(*jargs, chunk=64, state=wst)
    gh2, gst2 = X.mlstm_chunked(*targs, chunk=64, state=gst)
    _close(gh2, wh2)
    for g, w in zip(gst2, wst2):
        _close(g, w)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        X.mlstm_chunked(*(t[:, :40] for t in targs), chunk=32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_and_decode_match_jax(pair, kind):
    jcfg, tcfg, jparams, tparams = pair
    jfwd, jdec = ((JX.mlstm_block_fwd, JX.mlstm_block_decode)
                  if kind == "mlstm" else
                  (JX.slstm_block_fwd, JX.slstm_block_decode))
    tfwd, tdec = ((X.mlstm_block_fwd, X.mlstm_block_decode)
                  if kind == "mlstm" else
                  (X.slstm_block_fwd, X.slstm_block_decode))
    stack = f"{kind}_units"
    idx = (1, 0) if kind == "mlstm" else (1,)
    jp = jax.tree.map(lambda a: a[idx], jparams[stack])
    tp = T.layer_params(tparams[stack], *idx)
    x = np.random.default_rng(4).standard_normal((2, 12, jcfg.d_model)) \
        .astype(np.float32)
    wy, wst = jax.jit(lambda p, x: jfwd(p, jcfg, x, return_state=True))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        gy, gst = tfwd(tp, tcfg, torch.from_numpy(x), return_state=True)
    _close(gy, wy)
    _close_tree(gst, jax.device_get(wst))
    x1 = x[:, :1] * 0.5
    wy1, wst1 = jax.jit(lambda p, x, c: jdec(p, jcfg, x, c))(
        jp, jnp.asarray(x1), wst)
    with torch.no_grad():
        gy1, gst1 = tdec(tp, tcfg, torch.from_numpy(x1), gst)
    _close(gy1, wy1)
    _close_tree(gst1, jax.device_get(wst1))


def test_forward_and_cache_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = _tokens(2, 24, seed=1)
    want, _, wcache = jax.jit(lambda p, t: JT.forward(
        p, jcfg, {"tokens": t}, return_cache=True))(jparams, jnp.asarray(tok))
    with torch.no_grad():
        got, aux, gcache = T.forward(tparams, tcfg,
                                     {"tokens": torch.from_numpy(tok)},
                                     return_cache=True)
    assert float(aux) == 0.0
    _close(got, want)
    _close_tree(gcache, jax.device_get(wcache))


def test_decode_steps_from_a_bridged_cache_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = _tokens(2, 20, seed=2)
    _, jcache = jax.jit(lambda p, t: JT.prefill(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(tok))
    jfull = JT.graft_slot_cache(JT.init_cache(jcfg, 2, 64), jcache, 0)
    tfull = tree_from_numpy(jax.device_get(jfull), device="cpu")
    nxt = _tokens(2, 3, seed=4)
    step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for t, pos in enumerate([20, 21, np.array([22, 22], np.int32)]):
        want, jfull = step(jparams, jfull, jnp.asarray(nxt[:, t:t + 1]),
                           jnp.asarray(pos, jnp.int32))
        got, tfull = T.decode_step(tparams, tcfg, tfull,
                                   torch.from_numpy(nxt[:, t:t + 1]),
                                   torch.as_tensor(pos))
        _close(got, want)
    _close_tree(tfull, jax.device_get(jfull))


def test_prefill_then_decode_equals_forward(pair):
    """Prefill S tokens, decode token S: the logits equal a forward pass
    over S + 1 tokens (the twin of test_models.py's consistency test)."""
    _, cfg, _, params = pair
    tok = torch.from_numpy(_tokens(2, 25, seed=9))
    _, pcache = T.prefill(params, cfg, {"tokens": tok[:, :24]})
    cache = T.graft_slot_cache(T.init_cache(cfg, 2, 64, device="cpu"),
                               pcache, 0)
    got, _ = T.decode_step(params, cfg, cache, tok[:, 24:], 24)
    want, _ = T.forward(params, cfg, {"tokens": tok})
    torch.testing.assert_close(got[:, 0], want[:, -1], atol=2e-5, rtol=0)


def test_graft_and_extract_use_each_leaf_batch_axis(pair):
    """The batch axis is axis 2 of an mlstm_units leaf and axis 1 of an
    slstm_units leaf: a graft into slot 1 writes only that slot's rows
    (the other slots keep init_cache's values), and extract returns
    them."""
    _, cfg, _, params = pair
    _, pcache = T.prefill(params, cfg,
                          {"tokens": torch.from_numpy(_tokens(1, 12, 5))})
    init = T.init_cache(cfg, 3, 32, device="cpu")
    cache = T.graft_slot_cache(T.init_cache(cfg, 3, 32, device="cpu"),
                               pcache, 1)
    for name, sub in cache.items():
        axis = 2 if name == "mlstm_units" else 1
        for leaf, t in sub.items():
            for slot in (0, 2):
                assert torch.equal(t.select(axis, slot),
                                   init[name][leaf].select(axis, slot))
            assert torch.equal(t.narrow(axis, 1, 1), pcache[name][leaf])
    got = T.extract_slot_cache(cache, T.init_cache(cfg, 1, 32, device="cpu"),
                               1)
    for name, sub in pcache.items():
        for leaf, t in sub.items():
            assert torch.equal(got[name][leaf], t), (name, leaf)


def test_serving_engine_generate_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    prompts = _tokens(3, 16, seed=6)
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(prompts,
                                                             max_new=6)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(prompts,
                                                                 max_new=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.prompt_logits, want.prompt_logits)
    _close(got.logits_last, want.logits_last)


def _trace(cls, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(1, 512, n).astype(np.int32), max_new=m,
                arrival_t=t) for n, m, t in TRACE]


def test_continuous_engine_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    jreqs, treqs = _trace(JRequest), _trace(Request)
    jeng = JEngine(jcfg, jparams, n_slots=2, max_seq=MAX_SEQ)
    teng = ContinuousEngine(tcfg, tparams, n_slots=2, max_seq=MAX_SEQ)
    assert teng.kv_layout == jeng.kv_layout == "contiguous"
    jres, tres = jeng.run(jreqs), teng.run(treqs)
    assert teng.clock == jeng.clock
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tres[tr.rid].tokens, jres[jr.rid].tokens)
        _close(tres[tr.rid].logits_last, jres[jr.rid].logits_last)


def test_midflight_join_matches_solo(pair):
    """A request joining while another decodes gets the tokens of a solo
    run (the twin of test_continuous_batching.py's all-families test)."""
    _, cfg, _, params = pair
    rng = np.random.default_rng(6)
    probe = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
    filler = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
    solo = ContinuousEngine(cfg, params, n_slots=2, max_seq=64)
    (want,) = solo.run([Request(prompt=probe, max_new=5)]).values()
    joint = ContinuousEngine(cfg, params, n_slots=2, max_seq=64)
    req = Request(prompt=probe, max_new=5, arrival_t=2.0)
    got = joint.run([Request(prompt=filler, max_new=7), req])
    np.testing.assert_array_equal(got[req.rid].tokens, want.tokens)


def test_bridge_checks_every_leaf_and_keeps_gate_biases_fp32(pair):
    jcfg, tcfg, jparams, _ = pair
    tree = jax.device_get(jparams)
    bad = jax.tree.map(lambda a: a, tree)
    bad["slstm_units"]["r_gates"] = bad["slstm_units"]["r_gates"][..., :-1]
    with pytest.raises(ValueError, match="r_gates"):
        params_from_numpy(bad, tcfg, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["mlstm_units"]["w_extra"] = extra["mlstm_units"]["skip"]
    with pytest.raises(ValueError, match="w_extra"):
        params_from_numpy(extra, tcfg, device="cpu")
    bcfg = tcfg.with_(param_dtype="bfloat16", activation_dtype="bfloat16")
    p = T.init_params(bcfg, seed=0, device="cpu")
    assert p["mlstm_units"]["b_if"].dtype == torch.float32
    assert p["slstm_units"]["b_gates"].dtype == torch.float32
    assert p["mlstm_units"]["w_q"].dtype == torch.bfloat16
    jb = jax.eval_shape(lambda k: JT.init_params(k, jcfg.with_(
        param_dtype="bfloat16", activation_dtype="bfloat16"), max_seq=32),
        jax.random.PRNGKey(1))
    params_from_numpy(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jb),
                      bcfg, device="cpu")


def test_paged_layout_is_refused(pair):
    _, cfg, _, params = pair
    with pytest.raises(NotImplementedError, match="recurrent"):
        ContinuousEngine(cfg, params, max_seq=64, kv_layout="paged")


@pytest.mark.parametrize("extra", [[], ["--continuous"]])
def test_launcher_serves_xlstm_on_cpu(capsys, extra):
    serve.main(["--arch", "xlstm-1.3b", "--reduced", "--batch", "2",
                "--prompt-len", "12", "--max-new", "3", "--max-seq", "32",
                "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert out.count("escalate=") == (4 if extra else 2)


@pytest.mark.parametrize("mode", ["spill", "recompute"])
def test_preemptive_scheduler_round_trip_is_token_exact(pair, mode):
    """PreemptiveScheduler over the ssm family (the contiguous slot
    manager's snapshot, detach and restore; or a re-prefill of prompt
    and emitted tokens): a sequence preempted after three tokens and
    resumed gives the tokens of an undisturbed run, and so do the
    others."""
    from repro_torch.serving.scheduler import PreemptiveScheduler
    _, cfg, _, params = pair
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(1, 512, n).astype(np.int32),
                    max_new=8) for n in (12, 20, 7)]
    solo = [r.clone() for r in reqs]
    want = ContinuousEngine(cfg, params, n_slots=4, max_seq=64).run(solo)
    eng = ContinuousEngine(cfg, params, n_slots=4, max_seq=64)
    sched = PreemptiveScheduler(eng)
    probes = [r.clone() for r in reqs]
    for p in probes:
        sched.submit(p)
    while not (eng.slots.decoding_slots() and len(
            eng.slots.states[eng.slots.decoding_slots()[0]].emitted) >= 3):
        sched.step()
    sched.preempt(eng.slots.decoding_slots()[0], mode)
    got = sched.run()
    assert sched.n_preemptions == 1 and sched.n_resumes == 1
    for p, s in zip(probes, solo):
        np.testing.assert_array_equal(got[p.rid].tokens, want[s.rid].tokens)
