"""The port's ``serving/speculative.py`` as the JAX package's
``tests/test_speculative.py`` holds the reference to it: greedy
draft-verify equals plain greedy decoding of the target (cross-model and
self-draft, where the final round drafts fewer tokens and the uplink
ledger meters only shipped ids), the engine's one-pass verify of a draft
stream, and the validation raises.  Then against the reference: both
packages' ``speculative_generate`` on the bridged tiansuan pair give the
same tokens, rounds, drafted, accepted and ledger.  The tiansuan pair
(configs/tiansuan_pair.py) at its own widths cut to 2 layers each, in
fp32 on the CPU, weights from seeds 0 (ONBOARD) and 1 (GROUND)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import tiansuan_pair as TP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.speculative import (  # noqa: E402
    SpeculativeDecoder, greedy_generate, speculative_generate)

MAX_SEQ = 64
F32 = dict(param_dtype="float32", activation_dtype="float32")
DCFG, TCFG = (c.with_(n_layers=2, **F32) for c in (TP.ONBOARD, TP.GROUND))


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
def pair():
    return (T.init_params(DCFG, seed=0, device="cpu"),
            T.init_params(TCFG, seed=1, device="cpu"))


def _prompt(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, S).astype(np.int32)


def _assert_drained(eng):
    alloc = eng.slots.allocator
    assert alloc.in_use == 0 and alloc.reserved == 0


def test_speculative_matches_greedy_cross_model(pair):
    dparams, tparams = pair
    prompt = _prompt(TCFG, 16, seed=3)
    want = greedy_generate(tparams, TCFG, prompt, max_new=12)
    got = speculative_generate(dparams, DCFG, tparams, TCFG, prompt,
                               max_new=12, k=4)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.tokens.dtype == np.int32 and want.dtype == np.int32
    assert got.rounds <= 12
    assert 0.0 <= got.acceptance_rate <= 1.0
    assert got.ledger.get("tokens_produced") == 12


def test_self_draft_truncation_accounting(pair):
    """Self-draft accepts every draft; with max_new % (k+1) != 0 the final
    round drafts fewer tokens: 4 then 1, uplink (4*4+16) + (4*1+16)."""
    dparams, _ = pair
    prompt = _prompt(DCFG, 12, seed=7)
    want = greedy_generate(dparams, DCFG, prompt, max_new=9)
    got = speculative_generate(dparams, DCFG, dparams, DCFG, prompt,
                               max_new=9, k=4)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.rounds == 2
    assert got.drafted == got.accepted == 5
    assert got.acceptance_rate == 1.0
    assert got.ledger.get("uplink_bytes") == 52
    assert got.ledger.get("tokens_produced") == 9


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("draft_k", 8)
    return ContinuousEngine(cfg, params, **kw)


def _plain_tokens(cfg, params, reqs):
    eng = _engine(cfg, params)
    res = eng.run([r.clone() for r in reqs])
    return [np.asarray(res[k].tokens, np.int32) for k in sorted(res)], \
        eng.clock


def test_engine_verifies_k_drafts_in_one_pass(pair):
    params = pair[0]
    reqs = [Request(prompt=_prompt(DCFG, S, seed=S), max_new=16)
            for S in (8, 11, 14)]
    plain, plain_clock = _plain_tokens(DCFG, params, reqs)
    eng = _engine(DCFG, params)
    spec_reqs = [r.clone() for r in reqs]
    for r, toks in zip(spec_reqs, plain):
        r.draft_toks = toks
    res = eng.run(spec_reqs)
    for a, b in zip([res[k].tokens for k in sorted(res)], plain):
        np.testing.assert_array_equal(a, b)
    st = eng.spec_stats()
    assert st["verify_passes"] >= 2 * len(reqs)
    assert st["drafted"] == st["accepted"] > 0
    assert st["draft_streams_dropped"] == 0
    assert eng.clock < plain_clock
    _assert_drained(eng)


def test_engine_verify_survives_corrupted_draft_tail(pair):
    params = pair[0]
    reqs = [Request(prompt=_prompt(DCFG, 10, seed=21), max_new=12)]
    (plain,), _ = _plain_tokens(DCFG, params, reqs)
    bad = plain.copy()
    bad[5] = (bad[5] + 1) % DCFG.vocab_size
    eng = _engine(DCFG, params)
    (result,) = eng.run([Request(prompt=reqs[0].prompt.copy(), max_new=12,
                                 draft_toks=bad)]).values()
    np.testing.assert_array_equal(result.tokens, plain)
    st = eng.spec_stats()
    assert 0 < st["accepted"] < st["drafted"]
    _assert_drained(eng)


def test_engine_drops_mismatched_draft_head(pair):
    params = pair[0]
    reqs = [Request(prompt=_prompt(DCFG, 10, seed=33), max_new=8)]
    (plain,), _ = _plain_tokens(DCFG, params, reqs)
    bad = plain.copy()
    bad[0] = (bad[0] + 1) % DCFG.vocab_size
    eng = _engine(DCFG, params)
    (result,) = eng.run([Request(prompt=reqs[0].prompt.copy(), max_new=8,
                                 draft_toks=bad)]).values()
    np.testing.assert_array_equal(result.tokens, plain)
    st = eng.spec_stats()
    assert st["draft_streams_dropped"] == 1 and st["verify_passes"] == 0
    _assert_drained(eng)


def test_rejects_batched_prompt(pair):
    dparams, tparams = pair
    batched = _prompt(TCFG, 8)[None, :]
    with pytest.raises(ValueError, match="single"):
        greedy_generate(tparams, TCFG, batched, max_new=4)
    with pytest.raises(ValueError, match="single"):
        speculative_generate(dparams, DCFG, tparams, TCFG, batched,
                             max_new=4)


def test_rejects_bad_k_and_draft_budgets(pair):
    dparams, tparams = pair
    prompt = _prompt(TCFG, 8)
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate(dparams, DCFG, tparams, TCFG, prompt, k=0)
    with pytest.raises(ValueError, match="draft_k"):
        _engine(TCFG, tparams, draft_k=0)
    drf = _engine(DCFG, dparams, n_slots=1)
    tgt = _engine(TCFG, tparams, n_slots=1, draft_k=2)
    with pytest.raises(ValueError, match="exceeds"):
        SpeculativeDecoder(drf, tgt, k=4)
    with pytest.raises(NotImplementedError, match="paged"):
        SpeculativeDecoder(_engine(DCFG, dparams, kv_layout="contiguous"),
                           tgt, k=2)


def test_rejects_batched_draft_stream(pair):
    eng = _engine(DCFG, pair[0])
    with pytest.raises(ValueError, match="draft_toks"):
        eng.submit(Request(prompt=_prompt(DCFG, 8), max_new=4,
                           draft_toks=np.zeros((2, 3), np.int32)))


@pytest.fixture(scope="module")
def bridged():
    """The JAX package's pair (seeds 0 and 1, the same cut) and the same
    weights bridged into the port."""
    import jax
    from repro.configs import tiansuan_pair as jTP
    from repro.models import transformer as JT
    from repro_torch.bridge import params_from_numpy
    jd, jt = (c.with_(n_layers=2, **F32) for c in (jTP.ONBOARD, jTP.GROUND))
    jdp = JT.init_params(jax.random.PRNGKey(0), jd, max_seq=128)
    jtp = JT.init_params(jax.random.PRNGKey(1), jt, max_seq=128)
    return {"jax": ((jd, jdp), (jt, jtp)),
            "port": ((DCFG, params_from_numpy(jax.device_get(jdp), DCFG,
                                              device="cpu")),
                     (TCFG, params_from_numpy(jax.device_get(jtp), TCFG,
                                              device="cpu")))}


@pytest.mark.parametrize("case", ["self_draft", "cross_model"])
def test_speculative_generate_matches_reference(bridged, case):
    """Both packages' speculative_generate (k = draft_k = 8, as the
    smoke's speculative phase runs it) on the same bridged weights:
    identical tokens, rounds, drafted, accepted and ledger, for two
    prompts of 40 tokens (one set of compiled shapes) and max_new 24."""
    from repro.serving import speculative as jS
    rng = np.random.default_rng(12)
    out = {}
    for side, gen in (("jax", jS.speculative_generate),
                      ("port", speculative_generate)):
        (dcfg, dp), (tcfg, tp) = bridged[side]
        if case == "self_draft":
            tcfg, tp = dcfg, dp
        out[side] = [gen(dp, dcfg, tp, tcfg, prompt, max_new=24, k=8)
                     for prompt in rng.integers(1, DCFG.vocab_size, (2, 40))
                     .astype(np.int32)]
        rng = np.random.default_rng(12)
    for j, t in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert (t.rounds, t.drafted, t.accepted) == \
            (j.rounds, j.drafted, j.accepted)
        assert t.ledger.counters == j.ledger.counters
        if case == "self_draft":
            assert t.accepted == t.drafted > 0
