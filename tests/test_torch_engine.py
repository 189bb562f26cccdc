"""The port's paged ``ContinuousEngine`` and confidence gate against the
JAX package's, serving the same Poisson trace on the same weights: the
tiansuan ONBOARD tier at full width in fp32, with the scheduler's
prefill budget of 16 tokens and a speculative draft stream riding some
requests.  Greedy tokens, the unified step's clock, the speculative
counters and the gate's escalate flags must be identical; an escalate
flag may differ only for an item whose confidence lies within 1e-5 of
the 0.62 threshold, and such items are counted."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.tiansuan_pair import ONBOARD as J_ONBOARD  # noqa: E402
from repro.core.gating import ConfidenceGate as JGate  # noqa: E402
from repro.serving.batching import poisson_trace as j_trace  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.tiansuan_pair import ONBOARD as T_ONBOARD  # noqa: E402
from repro_torch.core.gating import ConfidenceGate as TGate  # noqa: E402
from repro_torch.serving.batching import poisson_trace as t_trace  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine as TEngine  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
ENGINE = dict(n_slots=3, max_seq=64, prefill_budget_tokens=16, draft_k=4)
TRACE = dict(rate=0.5, prompt_lens=(4, 40), max_new=(2, 12), vocab_size=512,
             seed=3)
THRESHOLD = 0.62


def _with_drafts(reqs, plain_tokens):
    """Attach the plain greedy continuation as a draft stream to every
    other request, corrupted at one position in some of them, so verify
    passes both accept and reject."""
    for i, r in enumerate(reqs):
        if i % 2:
            continue
        d = np.array(plain_tokens[i], np.int32)
        if i % 4 == 0 and len(d) > 3:
            d[3] = (d[3] + 1) % 512
        r.draft_toks = d
    return reqs


def test_engine_and_gate_match_jax():
    jcfg, tcfg = J_ONBOARD.with_(**F32), T_ONBOARD.with_(**F32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jeng = JEngine.init(jcfg, seed=0, **ENGINE)
    tparams = params_from_numpy(jax.device_get(jeng.params), tcfg,
                                device="cpu")
    jreqs, treqs = j_trace(6, **TRACE), t_trace(6, **TRACE)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.max_new, a.arrival_t) == (b.max_new, b.arrival_t)
    plain = jeng.run([r.clone() for r in jreqs])
    plain_tokens = [plain[rid].tokens for rid in sorted(plain)]

    jeng = JEngine(jcfg, jeng.params, **ENGINE)
    teng = TEngine(tcfg, tparams, **ENGINE)
    jres = jeng.run(_with_drafts(jreqs, plain_tokens))
    tres = teng.run(_with_drafts(treqs, plain_tokens))
    assert teng.clock == jeng.clock
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.spec_stats()["verify_passes"] > 0
    assert 0 < teng.spec_stats()["accepted"] < teng.spec_stats()["drafted"]
    assert teng.prefill_tokens_total == jeng.prefill_tokens_total

    jgate, tgate = JGate(threshold=THRESHOLD), TGate(threshold=THRESHOLD)
    near_threshold = 0
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        a, b = jres[jr.rid], tres[tr.rid]
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, plain_tokens[i])
        assert (b.admitted_step, b.first_token_step, b.finished_step) == \
            (a.admitted_step, a.first_token_step, a.finished_step)
        np.testing.assert_allclose(b.logits_last, a.logits_last, atol=1e-4,
                                   rtol=0)
        jd = jgate.decide(a.logits_last[None])
        td = tgate.decide(b.logits_last[None])
        conf = float(np.asarray(jd["confidence"])[0])
        np.testing.assert_allclose(float(td["confidence"][0]), conf,
                                   atol=1e-5, rtol=0)
        if abs(conf - THRESHOLD) < 1e-5:
            near_threshold += 1
            continue
        assert bool(td["escalate"][0]) == bool(np.asarray(jd["escalate"])[0])
        assert int(td["argmax"][0]) == int(np.asarray(jd["argmax"])[0])
    print(f"gate items within 1e-5 of the threshold: {near_threshold}")
    assert teng.kv_cache_stats()["peak_pages_in_use"] == \
        jeng.kv_cache_stats()["peak_pages_in_use"]
