"""The port's audio family (whisper-tiny: the encoder-decoder branches of
``models/transformer.py``, LayerNorm and the sinusoidal table of
``models/layers.py``, cross-attention in ``models/attention.py``, the
fixed-slot engine's ``audio_frames`` side input) against the JAX
package's.

Parity (same numpy-seeded inputs, JAX params and caches bridged into the
port, fp32 on the CPU, reduced whisper-tiny: 2 encoder + 2 decoder
layers of 128, 2 heads of 64, 96 frames): ``layernorm`` and
``sinusoidal_positions``; ``forward`` logits and its cache (the decoder's
self K/V and the cross K/V ``xk``/``xv``); decode steps from a bridged
cache (the learned position, the static cross cache);
``ServingEngine.generate`` greedy tokens; ``loss_fn`` and every gradient
leaf (remat on in both).  Twins on the port alone: prefill + decode ==
forward over S + 1 tokens (tests/test_models.py's invariant).  Refusals
kept from the reference: per-slot decode positions, paged decode and the
paged pool, the continuous engine; and the port's own: a decode position
past ``dec_pos`` raises (the reference's ``dynamic_slice`` clamps it).

Tolerances: logits, caches and decode steps atol 1e-4 (the same fp32
arithmetic, sums in another order by XLA and PyTorch's CPU kernels; seen
~2e-6 on logits); LayerNorm atol 1e-6, the sinusoidal table 1e-7 per
position (its fp32 angles); prefill
+ decode against forward atol 2e-5 (one model, the same kernels);
gradients as tests/test_torch_hybrid_training.py holds them (rtol 1e-4,
atol 1e-6 + 2e-5 of the leaf's largest entry; the unembedding weights
one bf16 ulp of theirs); tokens identical."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

ARCH = "whisper-tiny"
F32 = dict(param_dtype="float32", activation_dtype="float32")
MAX_SEQ = 48
B, S = 2, 12
ATOL = 1e-4
STEP_ATOL = 2e-5
METRIC_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL, GRAD_SCALE_ATOL = 1e-6, 1e-4, 2e-5
UNEMBED = ("embed", "lm_head")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = j_reduced(ARCH).with_(**F32), t_reduced(ARCH).with_(**F32)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg, max_seq=MAX_SEQ))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = (0.02 * rng.standard_normal(
        (B, jcfg.n_audio_frames, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, toks, frames


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks),
            "audio_frames": torch.from_numpy(frames)}


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "audio_frames": jnp.asarray(frames)}


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_configs_and_params_match_the_reference():
    jcfg, tcfg, jparams, tparams, _, _ = _setup()
    assert tcfg.family == "audio" and tcfg.is_encoder_decoder
    got = {"/".join(p): tuple(x.shape)
           for p, x in tree_leaves_with_path(tparams)}
    want = {"/".join(p): tuple(x.shape)
            for p, x in tree_leaves_with_path(jax.device_get(jparams))}
    assert got == want
    assert got["dec_pos"] == (MAX_SEQ, tcfg.d_model)
    # the port's own init draws the same tree
    mine = TT.init_params(tcfg, seed=0, device="cpu", max_seq=MAX_SEQ)
    assert {"/".join(p): tuple(x.shape)
            for p, x in tree_leaves_with_path(mine)} == want


def test_layernorm_and_sinusoidal_table_match_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 128)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(128).astype(np.float32),
         "bias": rng.standard_normal(128).astype(np.float32)}
    want = JL.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), 1e-6)
    got = L.norm({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), 1e-6)
    _close(got, want, atol=1e-6)
    # fp32 angles pos * inv round to ~6e-8 of themselves, so two fp32
    # tables (and each against float64) part by up to ~1e-7 x n_pos
    # (seen 1.2e-4 between them at 1500 positions, 1.0e-4 from float64)
    for n, d in ((96, 128), (1500, 384), (7, 2)):
        got = L.sinusoidal_positions(n, d, "cpu")
        ang = np.arange(n)[:, None] * np.exp(
            -np.arange(d // 2)[None] * np.log(10000.0) / max(d // 2 - 1, 1))
        assert got.dtype == torch.float32 and got.shape == (n, d)
        for want in (JL.sinusoidal_positions(n, d),
                     np.concatenate([np.sin(ang), np.cos(ang)], -1)):
            _close(got, want, atol=1e-7 * n + 1e-7)


def test_forward_logits_and_cache_match_jax():
    jcfg, tcfg, jparams, tparams, toks, frames = _setup()
    want, _, jcache = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b, return_cache=True))(jparams, _jbatch(toks, frames))
    with torch.no_grad():
        got, aux, cache = TT.forward(tparams, tcfg, _tbatch(toks, frames),
                                     return_cache=True)
    assert float(aux) == 0.0 and got.shape == (B, S + 1, tcfg.vocab_size)
    _close(got, want)
    assert set(cache) == {"dec"} and set(cache["dec"]) == {"k", "v", "xk",
                                                           "xv"}
    for leaf in ("k", "v", "xk", "xv"):
        _close(cache["dec"][leaf], jcache["dec"][leaf])
    assert cache["dec"]["xk"].shape[2] == jcfg.n_audio_frames


def test_decode_steps_from_a_bridged_cache_match_jax():
    """Three decode steps of both packages from the reference's prefill
    cache grafted into max_seq (the learned positions S.., the static
    cross cache)."""
    jcfg, tcfg, jparams, tparams, toks, frames = _setup()
    jeng = JServing(jcfg, jparams, max_seq=MAX_SEQ)
    _, jc = jeng._prefill(jparams, _jbatch(toks[:, :S], frames))
    jc = jeng.full_cache(jc, B)
    tc = tree_from_numpy(jax.device_get(jc), "cpu")
    for t in range(3):
        tok = toks[:, S - 1:S] if t == 0 else np.full((B, 1), 7 + t, np.int32)
        want, jc = jeng._decode(jparams, jc, jnp.asarray(tok),
                                jnp.int32(S + t))
        got, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok),
                                 S + t)
        _close(got, want)
    for leaf in ("k", "v", "xk", "xv"):
        _close(tc["dec"][leaf], jc["dec"][leaf])


def test_prefill_then_decode_equals_forward():
    """tests/test_models.py's invariant on the port: prefill S tokens,
    decode token S at position S against one forward over S + 1."""
    _, tcfg, _, tparams, toks, frames = _setup()
    with torch.no_grad():
        full, _ = TT.forward(tparams, tcfg, _tbatch(toks, frames))
    logits, pcache = TT.prefill(tparams, tcfg, _tbatch(toks[:, :S], frames))
    _close(logits[:, 0], full[:, S - 1], atol=STEP_ATOL)
    cache = TT.graft_slot_cache(TT.init_cache(tcfg, B, MAX_SEQ, "cpu"),
                                pcache, 0)
    step, _ = TT.decode_step(tparams, tcfg, cache,
                             torch.from_numpy(toks[:, S:S + 1]), S)
    _close(step[:, 0], full[:, S], atol=STEP_ATOL)


def test_generate_matches_jax():
    jcfg, tcfg, jparams, tparams, toks, frames = _setup()
    extra = {"audio_frames": frames}
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(
        toks[:, :S], max_new=6, extra_inputs=extra)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(
        toks[:, :S], max_new=6, extra_inputs=extra)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.prompt_logits, want.prompt_logits)
    _close(got.logits_last, want.logits_last)


def test_loss_and_every_gradient_leaf_match_jax():
    jcfg, tcfg, jparams, tparams, toks, frames = _setup()
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _jbatch(toks, frames))
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    ttot, tm = TT.loss_fn(p, tcfg, _tbatch(toks, frames))
    ttot.backward()
    for k in ("loss", "aux_loss", "mtp_loss", "perplexity"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   atol=METRIC_ATOL * max(1.0, float(jm[k])),
                                   err_msg=k)
    got = {"/".join(k): t.grad.numpy() for k, t in tree_leaves_with_path(p)}
    want = {"/".join(k): np.asarray(v)
            for k, v in tree_leaves_with_path(jax.device_get(jg))}
    assert set(got) == set(want)
    for path, w in want.items():
        atol = (2.0 ** -8 * float(np.abs(w).max()) if path in UNEMBED
                else GRAD_ATOL + GRAD_SCALE_ATOL * float(np.abs(w).max()))
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=GRAD_RTOL,
                                   err_msg=path)
    # the cross-attention and the encoder train
    for path in ("dec_blocks/xattn/w_k", "enc_blocks/attn/w_q", "dec_pos"):
        assert float(np.abs(got[path]).max()) > 0


def test_per_slot_positions_raise_in_both_packages():
    jcfg, tcfg, jparams, tparams, _, _ = _setup()
    jc = JT.init_cache(jcfg, B, MAX_SEQ)
    tc = TT.init_cache(tcfg, B, MAX_SEQ, "cpu")
    tok = np.ones((B, 1), np.int32)
    with pytest.raises(NotImplementedError, match="per-slot"):
        JT.decode_step(jparams, jcfg, jc, jnp.asarray(tok),
                       jnp.asarray([3, 4], jnp.int32))
    with pytest.raises(NotImplementedError, match="per-slot"):
        TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok),
                       torch.tensor([3, 4], dtype=torch.int32))


def test_paged_layout_and_continuous_engine_are_refused():
    jcfg, tcfg, jparams, tparams, _, _ = _setup()
    with pytest.raises(NotImplementedError, match="paged"):
        JT.decode_step(jparams, jcfg, JT.init_cache(jcfg, B, MAX_SEQ),
                       jnp.ones((B, 1), jnp.int32), jnp.int32(0),
                       block_tables=jnp.zeros((B, 2), jnp.int32))
    with pytest.raises(NotImplementedError, match="paged"):
        TT.decode_step(tparams, tcfg, TT.init_cache(tcfg, B, MAX_SEQ, "cpu"),
                       torch.ones((B, 1), dtype=torch.int32), 0,
                       block_tables=torch.zeros((B, 2), dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="paged"):
        TT.init_paged_cache(tcfg, 8, 16, "cpu")
    with pytest.raises(NotImplementedError):
        JEngine(jcfg, jparams, n_slots=1, max_seq=MAX_SEQ)
    with pytest.raises(NotImplementedError, match="'audio'"):
        ContinuousEngine(tcfg, tparams, n_slots=1, max_seq=MAX_SEQ)


def test_positions_past_dec_pos_raise(monkeypatch):
    """The reference's ``dynamic_slice`` clamps a decode position past
    ``dec_pos`` to its last row; the port raises before that, in
    ``decode_step`` and up front in ``generate``: against its max_seq,
    and against ``dec_pos``'s length when the engine's max_seq is longer
    than the params were made for (before any prefill runs)."""
    _, tcfg, _, tparams, toks, frames = _setup()
    tc = TT.init_cache(tcfg, B, MAX_SEQ + 4, "cpu")
    TT.decode_step(tparams, tcfg, tc, torch.ones((B, 1), dtype=torch.int32),
                   MAX_SEQ - 1)
    with pytest.raises(ValueError, match="dec_pos"):
        TT.decode_step(tparams, tcfg, tc,
                       torch.ones((B, 1), dtype=torch.int32), MAX_SEQ)
    with pytest.raises(ValueError, match="max_seq"):
        ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(
            toks[:, :S], max_new=MAX_SEQ - S + 1,
            extra_inputs={"audio_frames": frames})
    prefills = []
    monkeypatch.setattr(TT, "prefill",
                        lambda *a, **kw: prefills.append(a) or 1 / 0)
    with pytest.raises(ValueError, match="dec_pos"):
        ServingEngine(tcfg, tparams, max_seq=MAX_SEQ + 8).generate(
            toks[:, :S], max_new=MAX_SEQ - S + 1,
            extra_inputs={"audio_frames": frames})
    assert prefills == []
    monkeypatch.undo()
    long = np.ones((1, MAX_SEQ + 1), np.int32)
    with pytest.raises(ValueError, match="dec_pos"):
        TT.forward(tparams, tcfg, _tbatch(long, frames[:1]))


def test_bridge_refuses_a_tree_without_the_cross_attention():
    jcfg, tcfg, jparams, _, _, _ = _setup()
    tree = jax.device_get(jparams)
    tree["dec_blocks"] = {k: v for k, v in tree["dec_blocks"].items()
                          if k != "xattn"}
    with pytest.raises(ValueError, match="xattn"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_launchers_serve_and_train_whisper_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "8", "--max-new", "3", "--max-seq", "32",
                "--device", "cpu"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if "escalate=" in ln]
    assert len(rows) == 2
    state = train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                        "--batch", "1", "--seq", "16", "--device", "cpu"])
    assert state.step == 2 and np.isfinite(state.history[-1]["loss"])
    assert state.params["dec_pos"].shape[0] == 16
