"""The port's hybrid (zamba2: Mamba2 blocks plus one weight-shared
attention block) serving path against the JAX package's.

Parity (same numpy-seeded inputs, JAX params and caches bridged into the
port, fp32 on the CPU, reduced zamba2 at n_layers=3 so that both the
unit stack and the tail run): ``forward`` logits and its cache,
``prefill`` then ``decode_step`` (scalar and per-slot positions),
``ServingEngine.generate`` and ``ContinuousEngine`` (always on the
contiguous ``SlotManager`` for this family) with identical greedy
tokens, and the reference's ragged-prompt limitation kept: a prompt of
100 tokens at chunk 64 raises in both packages.

Twins, on the port alone: tests/test_models.py's prefill + decode ==
forward over S + 1 tokens, tests/test_continuous_batching.py's
mid-flight join == solo run, and a snapshot -> detach -> restore round
trip of a hybrid slot.

Tolerance: logits and caches atol 1e-4.  Both sides run the same fp32
arithmetic, but XLA and PyTorch's CPU kernels sum in other orders, and
the differences grow through the layers (seen: ~1e-5).  Tokens may not
differ at all."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

ATOL = 1e-4
KW = dict(param_dtype="float32", activation_dtype="float32", n_layers=3)
MAX_SEQ = 160
# prompt lengths the reference admits at chunk 64: below, at, and a
# multiple of the chunk
TRACE = [(5, 6, 0.0), (40, 4, 0.0), (64, 5, 1.0), (128, 3, 2.0),
         (17, 7, 2.0), (30, 2, 5.0)]                  # (len, max_new, t)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_reduced("zamba2-7b").with_(**KW), \
        t_reduced("zamba2-7b").with_(**KW)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=0)


def _tokens(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, (B, S)) \
        .astype(np.int32)


def test_forward_and_cache_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = _tokens(2, 24, seed=1)
    want, _, wcache = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(tok)},
                                 return_cache=True)
    got, aux, gcache = T.forward(tparams, tcfg,
                                 {"tokens": torch.from_numpy(tok)},
                                 return_cache=True)
    assert float(aux) == 0.0
    _close(got, want)
    assert set(gcache) == {"mamba_units", "shared_attn", "mamba_tail"}
    for name, sub in gcache.items():
        for leaf, t in sub.items():
            assert tuple(t.shape) == wcache[name][leaf].shape, (name, leaf)
            _close(t, wcache[name][leaf])


def test_prefill_decode_steps_match_jax(pair):
    """A bridged JAX cache (stale data past the prompt in every K/V row)
    decoded three steps on both sides, at one position for the batch
    and then at per-slot positions."""
    jcfg, tcfg, jparams, tparams = pair
    tok = _tokens(2, 20, seed=2)
    _, jcache = JT.prefill(jparams, jcfg, {"tokens": jnp.asarray(tok)})
    template = jax.device_get(JT.init_cache(jcfg, 2, 64))
    rng = np.random.default_rng(3)
    template["shared_attn"] = {k: rng.standard_normal(v.shape)
                               .astype(np.float32)
                               for k, v in template["shared_attn"].items()}
    jfull = JT.graft_slot_cache(jax.tree.map(jnp.asarray, template),
                                jcache, 0)
    tfull = tree_from_numpy(jax.device_get(jfull), device="cpu")
    nxt = _tokens(2, 3, seed=4)
    for t, pos in enumerate([20, 21, np.array([22, 22], np.int32)]):
        jpos = jnp.asarray(pos, jnp.int32)
        want, jfull = JT.decode_step(jparams, jcfg, jfull,
                                     jnp.asarray(nxt[:, t:t + 1]), jpos)
        got, tfull = T.decode_step(tparams, tcfg, tfull,
                                   torch.from_numpy(nxt[:, t:t + 1]),
                                   torch.as_tensor(pos))
        _close(got, want)
    for name, sub in tfull.items():
        for leaf, t in sub.items():
            _close(t, jfull[name][leaf])


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
    """The batch axis is axis 2 of a mamba_units leaf and axis 1 of the
    shared-attention and tail leaves: a graft into slot 1 writes only
    that slot's rows, and extract returns them."""
    _, cfg, _, params = pair
    _, pcache = T.prefill(params, cfg,
                          {"tokens": torch.from_numpy(_tokens(1, 12, 5))})
    cache = T.init_cache(cfg, 3, 32, device="cpu")
    T.graft_slot_cache(cache, pcache, 1)
    for name, sub in cache.items():
        axis = 2 if name == "mamba_units" else 1
        for leaf, t in sub.items():
            for slot in (0, 2):
                assert not t.select(axis, slot).any(), (name, leaf, slot)
    got = T.extract_slot_cache(cache, T.init_cache(cfg, 1, 32, device="cpu"),
                               1)
    for name, sub in pcache.items():
        for leaf, t in sub.items():
            g = got[name][leaf]
            region = g[..., :t.shape[-3], :, :] if name == "shared_attn" else g
            assert torch.equal(region, t), (name, leaf)


def test_serving_engine_generate_matches_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    prompts = _tokens(3, 64, seed=6)
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(prompts,
                                                             max_new=7)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(prompts,
                                                                 max_new=7)
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
    jeng = JEngine(jcfg, jparams, n_slots=3, max_seq=MAX_SEQ)
    teng = ContinuousEngine(tcfg, tparams, n_slots=3, max_seq=MAX_SEQ)
    assert teng.kv_layout == jeng.kv_layout == "contiguous"
    jres, tres = jeng.run(jreqs), teng.run(treqs)
    assert teng.clock == jeng.clock
    t_idx = {r.rid: i for i, r in enumerate(treqs)}
    j_idx = {r.rid: i for i, r in enumerate(jreqs)}
    assert [t_idx[rid] for rid in teng.finish_order] == \
        [j_idx[rid] for rid in jeng.finish_order]
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


def test_slot_snapshot_detach_restore_is_token_exact(pair):
    """A decoding hybrid sequence snapshotted and detached, its row
    clobbered (recurrent state and K/V), then restored: the row comes
    back bit for bit and the tokens equal an undisturbed run."""
    _, cfg, _, params = pair
    prompt = np.arange(3, 17, dtype=np.int32)
    solo = ContinuousEngine(cfg, params, n_slots=2, max_seq=64)
    (want,) = solo.run([Request(prompt=prompt, max_new=8)]).values()
    eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64)
    req = Request(prompt=prompt, max_new=8)
    eng.submit(req)
    eng.step()
    eng.step()
    slots = eng.slots
    kv = slots.snapshot(0)
    st = slots.detach(0)
    for name, sub in slots.cache.items():
        axis = 2 if name == "mamba_units" else 1
        for t in sub.values():
            t.select(axis, 0).copy_(torch.randn(t.select(axis, 0).shape))
    slots.restore(0, st, kv)
    for name, sub in slots.cache.items():
        axis = 2 if name == "mamba_units" else 1
        for leaf, t in sub.items():
            assert torch.equal(t.narrow(axis, 0, 1), kv[name][leaf])
    got = eng.run()
    np.testing.assert_array_equal(got[req.rid].tokens, want.tokens)


def test_ragged_prompt_raises_in_both(pair):
    """Hybrid prompts run at their exact length, and the SSD scan needs a
    multiple of the chunk past it: 100 tokens at chunk 64 raise in the
    reference (AssertionError) and in the port (ValueError)."""
    jcfg, tcfg, jparams, tparams = pair
    assert tcfg.ssm.chunk == 64
    prompt = np.arange(1, 101, dtype=np.int32)
    with pytest.raises(AssertionError):
        JEngine(jcfg, jparams, n_slots=2, max_seq=MAX_SEQ).run(
            [JRequest(prompt=prompt, max_new=2)])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ContinuousEngine(tcfg, tparams, n_slots=2, max_seq=MAX_SEQ).run(
            [Request(prompt=prompt, max_new=2)])


def test_paged_layout_is_refused(pair):
    _, cfg, _, params = pair
    with pytest.raises(NotImplementedError, match="recurrent"):
        ContinuousEngine(cfg, params, max_seq=64, kv_layout="paged")


@pytest.mark.parametrize("extra", [[], ["--continuous"]])
def test_launcher_serves_hybrid_on_cpu(capsys, extra):
    serve.main(["--arch", "zamba2-7b", "--reduced", "--batch", "2",
                "--prompt-len", "12", "--max-new", "3", "--max-seq", "32",
                "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert out.count("escalate=") == (4 if extra else 2)
