"""The port's training path against the JAX package's on the same
weights and batches, in fp32: ``data/tokens`` draw for draw,
``models/transformer.py::loss_fn`` (loss, metrics and every gradient
leaf) for the dense family (the tiansuan ONBOARD tier and the reduced
smollm-360m) and the moe family (the reduced qwen3-moe and deepseek-v3,
whose load-balance aux and MTP head train), ``mtp_logits``, and three
steps of ``training/loop.py::train`` (the port with remat on and off).
JAX params are bridged into the port (``repro_torch.bridge``).

Tolerances, all stated here: loss and metrics atol 1e-5; gradients
atol 1e-6 + rtol 1e-4 on every leaf but the unembedding weight (the
tied ``embed`` or ``lm_head``), which gets one bf16 ulp of its largest
entry: both sides round the unembedding weight to bf16
(``layers.unembed``), so its fp32 gradient is rounded to bf16 on the way
back and a last-bit difference in the fp32 product can flip one
rounding.  Params after three AdamW steps (lr 5e-4, 1e-3, 1e-3: an
entry moves by at most 2.5e-3): atol 1e-4.  AdamW's step
mhat / (sqrt(vhat) + eps) is ~1 whatever the gradient's size, so an
entry whose gradient sits near zero turns a last-bit difference into a
step difference (3.4e-5 seen); a wrong update moves entries by ~1e-3.
Hidden states: atol 1e-5 of their largest magnitude (deepseek-v3's
reach ~800 on random weights); MTP logits atol 1e-4.  Sums run in
another order on the two sides, so results differ in the last bits."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.data.tokens import TokenStreamConfig as JStreamConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import loop as JL  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import loop as TL  # noqa: E402
from repro_torch.training import optim as TO  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
DENSE = ["tiansuan_pair", "smollm-360m"]        # reduced: tiansuan ONBOARD
MOE = ["qwen3-moe-30b-a3b", "deepseek-v3-671b"]
SEQ, BATCH = 32, 2
METRIC_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
UNEMBED = ("embed", "lm_head")
PARAM_ATOL = 1e-4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jcfg, tcfg, JAX params, the same params in the port); cached per
    arch: neither side writes them."""
    jcfg, tcfg = j_reduced(arch).with_(**F32), t_reduced(arch).with_(**F32)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg, max_seq=SEQ))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _stream_cfg(vocab, seed=0):
    return dict(vocab_size=vocab, seq_len=SEQ, batch_size=BATCH, seed=seed)


def _by_path(tree) -> dict:
    return {"/".join(p): np.asarray(x.detach() if torch.is_tensor(x) else x,
                                    np.float32)
            for p, x in tree_leaves_with_path(tree)}


def _close_grads(got: dict, want: dict):
    assert set(got) == set(want)
    for path, w in want.items():
        atol = (2.0 ** -8 * float(np.abs(w).max())
                if path in UNEMBED else GRAD_ATOL)
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=GRAD_RTOL,
                                   err_msg=path)


def _loss_and_grads(jcfg, tcfg, jparams, tparams, toks):
    jf = jax.jit(jax.value_and_grad(
        lambda p, t: JT.loss_fn(p, jcfg, {"tokens": t}), has_aux=True))
    (jtot, jm), jg = jf(jparams, jnp.asarray(toks))
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    ttot, tm = TT.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)})
    ttot.backward()
    for k in ("loss", "aux_loss", "mtp_loss", "perplexity"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   atol=METRIC_ATOL * max(1.0, float(jm[k])),
                                   err_msg=k)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot),
                               atol=METRIC_ATOL)
    _close_grads(_by_path(tree_map(lambda t: t.grad, p)),
                 _by_path(jax.device_get(jg)))
    return jm, tm, p


@pytest.mark.parametrize("seed,vocab,seq,batch",
                         [(0, 512, 96, 8), (7, 49152, 33, 3), (999, 5, 4, 2)])
def test_token_stream_matches_reference_draw_for_draw(seed, vocab, seq,
                                                      batch):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    js, ts = JStream(JStreamConfig(**kw)), TokenStream(TokenStreamConfig(**kw))
    for step in (0, 1, 10_000):
        want, got = js.batch(step)["tokens"], ts.batch(step)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for want, got, _ in zip(iter(js), iter(ts), range(3)):
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_and_every_gradient_leaf(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = TokenStream(TokenStreamConfig(**_stream_cfg(jcfg.vocab_size))) \
        .batch(0)["tokens"]
    _, tm, _ = _loss_and_grads(jcfg, tcfg, jparams, tparams, toks)
    assert float(tm["aux_loss"]) == 0.0 and float(tm["mtp_loss"]) == 0.0


def test_loss_mask_branch():
    """``loss_mask`` weights the next-token nll by mask[:, 1:]."""
    jcfg, tcfg, jparams, tparams = _setup(DENSE[0])
    toks = TokenStream(TokenStreamConfig(**_stream_cfg(jcfg.vocab_size))) \
        .batch(3)["tokens"]
    mask = (np.arange(SEQ)[None] % 3 != 0).astype(np.float32) \
        .repeat(BATCH, 0)
    jl, jm = JT.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                        "loss_mask": jnp.asarray(mask)})
    with torch.no_grad():
        tl, tm = TT.loss_fn(tparams, tcfg, {"tokens": torch.from_numpy(toks),
                                            "loss_mask":
                                                torch.from_numpy(mask)})
    np.testing.assert_allclose(float(tl), float(jl), atol=METRIC_ATOL)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=METRIC_ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_mtp_and_every_gradient_leaf(arch):
    """The moe family's load-balance aux (routing with capacity, as in
    training) and, for deepseek-v3, the MTP loss, with every gradient
    leaf, the router's and the MTP head's among them; then deepseek-v3's
    ``mtp_logits``: shape (B, S-2, V) and values."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    toks = TokenStream(TokenStreamConfig(**_stream_cfg(jcfg.vocab_size))) \
        .batch(1)["tokens"]
    jm, tm, p = _loss_and_grads(jcfg, tcfg, jparams, tparams, toks)
    assert float(tm["aux_loss"]) > 0
    assert any(float(x.grad.abs().max()) > 0
               for _, x in tree_leaves_with_path(p["blocks_moe"]["moe"]
                                                 ["router"]))
    if not tcfg.use_mtp:
        return
    assert float(tm["mtp_loss"]) > 0
    assert max(float(x.grad.abs().max())
               for _, x in tree_leaves_with_path(p["mtp"])) > 0
    # mtp_logits (B, S-2, V) on the forward's hidden states

    def jmtp(params, t):
        _, _, h = JT.forward(params, jcfg, {"tokens": t}, return_hidden=True,
                             remat=False)
        return h, JT.mtp_logits(params, jcfg, h, t)
    jh, want = jax.jit(jmtp)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tt = torch.from_numpy(toks)
        _, _, th = TT.forward(tparams, tcfg, {"tokens": tt},
                              return_hidden=True, remat=False)
        got = TT.mtp_logits(tparams, tcfg, th, tt)
    assert got.shape == (BATCH, SEQ - 2, tcfg.vocab_size) == want.shape
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(jh).max()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_three_train_steps_match_reference(arch):
    """Three steps of ``train`` (lr 1e-3, warmup 2) on the same stream:
    every step's logged loss, grad norm and lr, then every param; the
    port's ``train`` runs remat, a second port run drives
    ``make_train_step(remat=False)`` by hand."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    scfg = _stream_cfg(jcfg.vocab_size, seed=5)
    jopt = JO.OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    topt = TO.OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jst = JL.TrainState(params=jparams, opt_state=JO.adamw_init(jparams,
                                                                jopt))
    jst = JL.train(jcfg, jst, iter(JStream(JStreamConfig(**scfg))), jopt,
                   steps=STEPS, log_every=1)
    tst = TL.TrainState(params=tparams, opt_state=TO.adamw_init(tparams,
                                                                topt))
    tst = TL.train(tcfg, tst, iter(TokenStream(TokenStreamConfig(**scfg))),
                   topt, steps=STEPS, log_every=1)
    assert tst.step == jst.step == STEPS
    assert [r["step"] for r in tst.history] == [1, 2, 3]
    for jr, tr in zip(jst.history, tst.history):
        assert set(jr) == set(tr)
        for k in ("loss", "grad_norm", "lr", "perplexity"):
            np.testing.assert_allclose(tr[k], jr[k], atol=METRIC_ATOL,
                                       rtol=1e-5, err_msg=k)
    want = _by_path(jax.device_get(jst.params))
    step = make_train_step(tcfg, topt, remat=False)
    params, opt = tparams, TO.adamw_init(tparams, topt)
    stream = TokenStream(TokenStreamConfig(**scfg))
    for i in range(STEPS):
        params, opt, m = step(params, opt, {
            "tokens": torch.from_numpy(stream.batch(i)["tokens"])})
        np.testing.assert_allclose(float(m["loss"]), jst.history[i]["loss"],
                                   atol=METRIC_ATOL)
    for got in (_by_path(tst.params), _by_path(params)):
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, atol=PARAM_ATOL,
                                       rtol=0, err_msg=path)


def test_hybrid_refuses_to_train_and_serving_records_no_graph():
    """The hybrid family used to raise under autograd; since its SSD
    scan runs through ``models.ssm.SSDChunkScan`` it records a graph
    (its parity with the reference's gradients is
    tests/test_torch_hybrid_training.py's), and under no_grad it serves
    with none.  A dense forward under no_grad records no graph even
    with params that require grad."""
    cfg = t_reduced("zamba2-7b").with_(**F32)
    params = tree_map(lambda t: t.requires_grad_(True),
                      TT.init_params(cfg, seed=0, device="cpu"))
    toks = {"tokens": torch.zeros((1, 64), dtype=torch.int32)}
    assert TT.forward(params, cfg, toks)[0].grad_fn is not None
    with torch.no_grad():
        logits, _ = TT.forward(params, cfg, toks)
    assert logits.grad_fn is None
    dcfg = t_reduced(DENSE[0]).with_(**F32)
    dparams = tree_map(lambda t: t.requires_grad_(True),
                       TT.init_params(dcfg, seed=0, device="cpu"))
    with torch.no_grad():
        logits, _ = TT.forward(dparams, dcfg, {"tokens": toks["tokens"]})
    assert logits.grad_fn is None
    assert TT.forward(dparams, dcfg, toks)[0].grad_fn is not None
