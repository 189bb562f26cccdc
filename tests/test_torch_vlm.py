"""The port's vlm family (qwen2-vl-2b: M-RoPE in ``models/layers.py`` and
``models/attention.py``, the patch embeddings ahead of the text in
``models/transformer.py``, the fixed-slot engine's ``patch_embeds``
side input) against the JAX package's.

Parity (same numpy-seeded inputs, JAX params bridged into the port, fp32
on the CPU, reduced qwen2-vl-2b: 2 layers of 256, 4/2 heads of 64,
sections (8, 12, 12), 16 patches): ``mrope_positions`` exactly;
``apply_rope`` with sections; ``forward`` logits and cache; decode steps
from a bridged cache; ``ServingEngine.generate`` greedy tokens; ``loss_fn``
(text positions only) and every gradient leaf.  The reference's patch-
count quirk, kept on purpose: decode's rotary position counts
``cfg.n_patches`` while prefill and ``generate`` count the request's own
patches, so at another patch count prefill + decode no longer equals one
forward; both packages give the same tokens and logits there too.
Refusals kept from the reference: the continuous engine (both families)
and the paged pool.

Tolerances: as tests/test_torch_whisper.py (logits and caches atol 1e-4;
rotary atol 1e-6; prefill + decode against forward atol 2e-5; gradients
rtol 1e-4, atol 1e-6 + 2e-5 of the leaf's largest entry, the tied
embedding one bf16 ulp of its largest entry); positions and tokens
identical."""
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

ARCH = "qwen2-vl-2b"
F32 = dict(param_dtype="float32", activation_dtype="float32")
MAX_SEQ = 64
B, S = 2, 10
ATOL = 1e-4
STEP_ATOL = 2e-5
METRIC_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL, GRAD_SCALE_ATOL = 1e-6, 1e-4, 2e-5


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
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _patches(cfg, n, seed=4):
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32)


def _tbatch(toks, pe):
    return {"tokens": torch.from_numpy(toks),
            "patch_embeds": torch.from_numpy(pe)}


def _jbatch(toks, pe):
    return {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)}


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("n_patches,s_text,offset",
                         [(16, 10, 0), (9, 5, 0), (0, 4, 0), (10, 3, 7)])
def test_mrope_positions_equal_the_reference(n_patches, s_text, offset):
    jcfg, tcfg, _, _, _ = _setup()
    got = TT.mrope_positions(tcfg, B, n_patches, s_text, offset)
    want = np.asarray(JT.mrope_positions(jcfg, B, n_patches, s_text,
                                         offset))
    assert got.shape == (3, B, n_patches + s_text)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections,hd", [((8, 12, 12), 64),
                                         ((16, 24, 24), 128)])
def test_apply_rope_with_sections_matches_jax(sections, hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((B, 7, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 50, (3, B, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       sections)
    _close(got, want, atol=1e-6)
    # three equal streams are plain rotary
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(same), 1e6,
                        sections),
           L.apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6),
           atol=1e-6)


def test_forward_logits_and_cache_match_jax():
    jcfg, tcfg, jparams, tparams, toks = _setup()
    pe = _patches(jcfg, jcfg.n_patches)
    want, _, jcache = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b, return_cache=True))(jparams, _jbatch(toks, pe))
    with torch.no_grad():
        got, _, cache = TT.forward(tparams, tcfg, _tbatch(toks, pe),
                                   return_cache=True)
    assert got.shape == (B, jcfg.n_patches + S + 1, jcfg.vocab_size)
    _close(got, want)
    for leaf in ("k", "v"):
        _close(cache["blocks"][leaf], jcache["blocks"][leaf])


def test_decode_steps_from_a_bridged_cache_match_jax():
    jcfg, tcfg, jparams, tparams, toks = _setup()
    pe = _patches(jcfg, jcfg.n_patches)
    jeng = JServing(jcfg, jparams, max_seq=MAX_SEQ)
    _, jc = jeng._prefill(jparams, _jbatch(toks[:, :S], pe))
    jc = jeng.full_cache(jc, B)
    tc = tree_from_numpy(jax.device_get(jc), "cpu")
    pos = S + jcfg.n_patches
    for t in range(3):
        tok = toks[:, S:S + 1] if t == 0 else np.full((B, 1), 5 + t, np.int32)
        want, jc = jeng._decode(jparams, jc, jnp.asarray(tok),
                                jnp.int32(pos + t))
        got, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(tok),
                                 pos + t)
        _close(got, want)
    _close(tc["blocks"]["k"], jc["blocks"]["k"])


@pytest.mark.parametrize("n_patches", [16, 9])
def test_prefill_then_decode_against_forward(n_patches):
    """At ``cfg.n_patches`` (16) prefill S + decode one token equals one
    forward over S + 1 (tests/test_models.py's invariant).  At 9 patches
    decode's rotary position is still counted from 16 patches (the
    reference's quirk), so the step differs from the forward there, in
    both packages alike."""
    jcfg, tcfg, jparams, tparams, toks = _setup()
    pe = _patches(jcfg, n_patches)
    with torch.no_grad():
        full, _ = TT.forward(tparams, tcfg, _tbatch(toks, pe))
    logits, pcache = TT.prefill(tparams, tcfg, _tbatch(toks[:, :S], pe))
    _close(logits[:, 0], full[:, -2], atol=STEP_ATOL)
    cache = TT.graft_slot_cache(TT.init_cache(tcfg, B, MAX_SEQ, "cpu"),
                                pcache, 0)
    step, _ = TT.decode_step(tparams, tcfg, cache,
                             torch.from_numpy(toks[:, S:S + 1]),
                             S + n_patches)
    gap = float((step[:, 0] - full[:, -1]).abs().max())
    if n_patches == jcfg.n_patches:
        assert gap <= STEP_ATOL
    else:
        assert gap > 100 * STEP_ATOL
    jeng = JServing(jcfg, jparams, max_seq=MAX_SEQ)
    _, jc = jeng._prefill(jparams, _jbatch(toks[:, :S], pe))
    want, _ = jeng._decode(jparams, jeng.full_cache(jc, B),
                           jnp.asarray(toks[:, S:S + 1]),
                           jnp.int32(S + n_patches))
    _close(step, want)


@pytest.mark.parametrize("n_patches", [16, 9])
def test_generate_matches_jax(n_patches):
    """At the config's patch count and at another (the quirk: decode's
    rotary positions shift, in both packages alike)."""
    jcfg, tcfg, jparams, tparams, toks = _setup()
    extra = {"patch_embeds": _patches(jcfg, n_patches)}
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(
        toks[:, :S], max_new=6, extra_inputs=extra)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(
        toks[:, :S], max_new=6, extra_inputs=extra)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.prompt_logits, want.prompt_logits)
    _close(got.logits_last, want.logits_last)


def test_loss_and_every_gradient_leaf_match_jax():
    jcfg, tcfg, jparams, tparams, toks = _setup()
    pe = _patches(jcfg, jcfg.n_patches)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, _jbatch(toks, pe))
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    ttot, tm = TT.loss_fn(p, tcfg, _tbatch(toks, pe))
    ttot.backward()
    for k in ("loss", "aux_loss", "mtp_loss", "perplexity"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   atol=METRIC_ATOL * max(1.0, float(jm[k])),
                                   err_msg=k)
    # the text positions only: S tokens give S - 1 targets
    with torch.no_grad():
        logits, _ = TT.forward(tparams, tcfg, _tbatch(toks, pe))
    text = torch.log_softmax(logits[:, -(S + 1):-1], -1)
    nll = -text.gather(-1, torch.from_numpy(toks[:, 1:]).long()[..., None])
    np.testing.assert_allclose(float(tm["loss"].detach()), float(nll.mean()),
                               atol=METRIC_ATOL)
    got = {"/".join(k): t.grad.numpy() for k, t in tree_leaves_with_path(p)}
    want = {"/".join(k): np.asarray(v)
            for k, v in tree_leaves_with_path(jax.device_get(jg))}
    assert set(got) == set(want)
    for path, w in want.items():
        atol = (2.0 ** -8 * float(np.abs(w).max()) if path == "embed"
                else GRAD_ATOL + GRAD_SCALE_ATOL * float(np.abs(w).max()))
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=GRAD_RTOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-tiny"])
def test_continuous_engine_refuses_both_families(arch):
    with pytest.raises(NotImplementedError):
        JEngine(j_reduced(arch), {}, n_slots=1, max_seq=32)
    with pytest.raises(NotImplementedError, match="does not serve"):
        ContinuousEngine(t_reduced(arch), {"embed": torch.zeros(1)},
                         n_slots=1, max_seq=32)


def test_paged_pool_is_refused():
    _, tcfg, _, _, _ = _setup()
    with pytest.raises(NotImplementedError, match="paged"):
        TT.init_paged_cache(tcfg, 8, 16, "cpu")


def test_max_seq_counts_the_patches():
    """S + patches + max_new past max_seq raises before any work (the
    reference would write past its cache); at the limit it serves."""
    jcfg, tcfg, _, tparams, toks = _setup()
    eng = ServingEngine(tcfg, tparams, max_seq=S + jcfg.n_patches + 4)
    extra = {"patch_embeds": _patches(jcfg, jcfg.n_patches)}
    with pytest.raises(ValueError, match="patches"):
        eng.generate(toks[:, :S], max_new=5, extra_inputs=extra)
    assert eng.generate(toks[:, :S], max_new=4,
                        extra_inputs=extra).tokens.shape == (B, 4)


def test_launchers_serve_and_train_qwen2_vl_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                "--prompt-len", "8", "--max-new", "3", "--max-seq", "32",
                "--device", "cpu"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if "escalate=" in ln]
    assert len(rows) == 2
    state = train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                        "--batch", "1", "--seq", "16", "--device", "cpu"])
    assert state.step == 2 and np.isfinite(state.history[-1]["loss"])
