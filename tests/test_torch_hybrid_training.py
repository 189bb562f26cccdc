"""Training the recurrent families in the port against the JAX package,
in fp32 on bridged weights: zamba2 (hybrid: Mamba2 blocks whose SSD scan
runs under autograd through ``models.ssm.SSDChunkScan``, plus the
weight-shared attention block; reduced at n_layers=3 so that the unit
stack and the tail both train) and xLSTM (ssm; reduced at n_layers=4,
two units).

* ``loss_fn`` (loss, metrics) and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``loss_fn``, with remat on
  in both.
* One ``make_train_step`` step (remat off) against the reference's
  gradient and ``adamw_update``: the new params.
* ``SSDChunkScan`` alone: its gradients against autograd through the
  plain scan, at group-level B/C views as ``mamba2_fwd`` passes them.
* ``launch/train`` runs both families on the CPU.

A fault of the reference, kept out of the port: its ``ssd_chunked``
masks the intra-chunk decay AFTER the exp (``jnp.where(tri, Smat *
jnp.exp(decay), 0.0)``, ``repro/models/ssm.py:104``), so where the
masked half's l_t - l_s passes ~88.7 the exp is inf and ``where``'s
backward multiplies a zero cotangent by it: NaN gradients.  Reduced
zamba2 at three layers reaches it (the tail's dt grows after the shared
block) and every gradient leaf upstream of the tail is NaN.  The port's
plain scan masks before the exp (``kernels/ref.py::ssm_chunk_scan_ref``).
The zamba2 parity tests therefore hold the port against the reference
with that one line's mask moved before the exp (the same forward
values); a separate test shows the unmodified reference's NaN and the
port's finite gradients.

Tolerances, those of tests/test_torch_training.py where they hold:
loss and metrics atol 1e-5; gradients rtol 1e-4 and atol 1e-6 plus
2e-5 of the leaf's largest entry (GRAD_SCALE_ATOL) on every leaf but the
unembedding weight (``embed``, ``lm_head``: one bf16 ulp of its largest
entry, as both sides round it to bf16 in ``layers.unembed``).  The
scaled term is this file's: fp32 sums in another order err in
proportion to the terms summed, and the recurrent blocks' gradient
leaves reach ~1-2.5 here (zamba2's Mamba2 ``conv_b``; the dense and moe
leaves of tests/test_torch_training.py stay below ~0.5), where every
leaf errs 2e-6 to 8e-6 of its largest entry (seen), a wrong gradient
by O(1) of it.  Params after one
AdamW step atol 1e-4, except entries whose reference gradient is within
GRAD_ATOL of zero: atol 2 * lr there.  AdamW's first step is lr * g /
(|g| + eps), so a gradient of ~1e-8 (seen: 7e-9 to 2e-7 on xLSTM's
projections) turns a difference inside the gradients' own tolerance
into a step difference of up to 2 * lr (seen 1.4e-4); a wrong update
moves every entry by ~lr.  ``SSDChunkScan`` against autograd through
the same plain scan: atol 1e-6 (the same operations, recomputed)."""
import contextlib
import functools
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.training import optim as TO  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402
from torch_inputs import ssm_inputs  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
LAYERS = {"zamba2-7b": 3, "xlstm-1.3b": 4}
SEQ, BATCH = 32, 2
METRIC_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
GRAD_SCALE_ATOL = 2e-5
UNEMBED = ("embed", "lm_head")
PARAM_ATOL = 1e-4
SSD_ATOL = 1e-6
LR = 1e-3
_WHERE_AFTER_EXP = (
    "    decay = lt[..., :, None] - lt[..., None, :]          # (B,nc,H,Lc,Lc)\n"
    "    tri = jnp.tril(jnp.ones((Lc, Lc), bool))\n"
    "    W = jnp.where(tri, Smat * jnp.exp(decay), 0.0)\n")
_MASK_BEFORE_EXP = (
    "    tri = jnp.tril(jnp.ones((Lc, Lc), bool))\n"
    "    decay = jnp.where(tri, lt[..., :, None] - lt[..., None, :], -jnp.inf)\n"
    "    W = Smat * jnp.exp(decay)\n")


@contextlib.contextmanager
def _reference_ssd_masked_before_exp():
    """The reference's ``ssd_chunked`` with its decay mask moved before
    the exp (the module docstring's fault): the same forward values, no
    NaN in its backward."""
    src = inspect.getsource(JS.ssd_chunked)
    assert src.count(_WHERE_AFTER_EXP) == 1, "the reference's scan changed"
    ns = dict(vars(JS))
    exec(src.replace(_WHERE_AFTER_EXP, _MASK_BEFORE_EXP), ns)
    saved = JS.ssd_chunked
    JS.ssd_chunked = ns["ssd_chunked"]
    try:
        yield
    finally:
        JS.ssd_chunked = saved


def _reference_loss_and_grads(jcfg, jparams, toks):
    return jax.jit(jax.value_and_grad(
        lambda p, t: JT.loss_fn(p, jcfg, {"tokens": t}), has_aux=True))(
        jparams, jnp.asarray(toks))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jcfg, tcfg, JAX params, the port's, a batch, the reference's
    loss, metrics and gradients on it); cached per arch."""
    kw = dict(F32, n_layers=LAYERS[arch])
    jcfg, tcfg = j_reduced(arch).with_(**kw), t_reduced(arch).with_(**kw)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg, max_seq=SEQ))(
        jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    toks = TokenStream(TokenStreamConfig(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, batch_size=BATCH,
        seed=1)).batch(0)["tokens"]
    with (_reference_ssd_masked_before_exp() if jcfg.family == "hybrid"
          else contextlib.nullcontext()):
        (jtot, jm), jg = _reference_loss_and_grads(jcfg, jparams, toks)
    return jcfg, tcfg, jparams, tparams, toks, (jtot, jm, jg)


def _by_path(tree) -> dict:
    return {"/".join(p): np.asarray(x.detach() if torch.is_tensor(x) else x,
                                    np.float32)
            for p, x in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("arch", list(LAYERS))
def test_loss_and_every_gradient_leaf_match_jax(arch):
    _, tcfg, _, tparams, toks, (jtot, jm, jg) = _setup(arch)
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    ttot, tm = TT.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)})
    ttot.backward()
    for k in ("loss", "aux_loss", "mtp_loss", "perplexity"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   atol=METRIC_ATOL * max(1.0, float(jm[k])),
                                   err_msg=k)
    np.testing.assert_allclose(float(ttot.detach()), float(jtot),
                               atol=METRIC_ATOL)
    got, want = _by_path(tree_map(lambda t: t.grad, p)), \
        _by_path(jax.device_get(jg))
    assert set(got) == set(want)
    for path, w in want.items():
        atol = (2.0 ** -8 * float(np.abs(w).max()) if path in UNEMBED
                else GRAD_ATOL + GRAD_SCALE_ATOL * float(np.abs(w).max()))
        np.testing.assert_allclose(got[path], w, atol=atol, rtol=GRAD_RTOL,
                                   err_msg=path)
    assert max(float(np.abs(g).max()) for g in got.values()) > 0


@pytest.mark.parametrize("arch", list(LAYERS))
def test_one_train_step_matches_reference_adamw(arch):
    _, tcfg, jparams, tparams, toks, (_, jm, jg) = _setup(arch)
    jopt = JO.OptimConfig(lr=LR, warmup_steps=0, total_steps=10)
    topt = TO.OptimConfig(lr=LR, warmup_steps=0, total_steps=10)
    want, _, _ = jax.jit(lambda p, g: JO.adamw_update(
        p, g, JO.adamw_init(p, jopt), jopt))(jparams, jg)
    step = make_train_step(tcfg, topt, remat=False)
    params, opt, m = step(tparams, TO.adamw_init(tparams, topt),
                          {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=METRIC_ATOL)
    assert int(opt["step"]) == 1
    got, grads = _by_path(params), _by_path(jax.device_get(jg))
    for path, w in _by_path(jax.device_get(want)).items():
        atol = np.where(np.abs(grads[path]) <= GRAD_ATOL, 2 * LR, PARAM_ATOL)
        assert (np.abs(got[path] - w) <= atol).all(), path
    # most entries move by ~lr, and those are held to PARAM_ATOL
    assert sum(int((np.abs(g) > GRAD_ATOL).sum()) for g in grads.values()) \
        > 0.9 * sum(g.size for g in grads.values())


def test_reference_ssd_gradient_is_nan_where_the_port_is_finite():
    """The unmodified reference's zamba2 gradients are NaN at reduced
    zamba2 with three layers (the module docstring's fault); the port's
    are finite, and its loss is the reference's."""
    jcfg, tcfg, jparams, tparams, toks, _ = _setup("zamba2-7b")
    (jtot, _), jg = _reference_loss_and_grads(jcfg, jparams, toks)
    assert not all(np.isfinite(g).all() for g in
                   _by_path(jax.device_get(jg)).values())
    p = tree_map(lambda t: t.clone().requires_grad_(True), tparams)
    ttot, _ = TT.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)})
    ttot.backward()
    np.testing.assert_allclose(float(ttot.detach()), float(jtot),
                               atol=METRIC_ATOL)
    assert all(torch.isfinite(t.grad).all()
               for _, t in tree_leaves_with_path(p))


def test_ssd_function_gradients_match_autograd_through_the_plain_scan():
    """Group-level B and C as views of one tensor (mamba2_fwd's cut), two
    chunks; the output and the final state both carry a cotangent."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in ssm_inputs(
        2, 32, 4, 8, 6, 1, seed=3))
    xbc = torch.cat([Bm, Cm], dim=-1).requires_grad_(True)
    x, dt, A = (t.requires_grad_(True) for t in (x, dt, A))
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((2, 32, 4, 8))
                          .astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 4, 8, 6))
                          .astype(np.float32))
    leaves = (x, dt, A, xbc)

    def run(fn):
        y, h = fn(x, dt, A, xbc[..., :6], xbc[..., 6:])
        return torch.autograd.grad((y, h), leaves, (dy, dh))
    got = run(lambda *a: SSM.SSDChunkScan.apply(*a, 16))
    want = run(lambda *a: ref.ssm_chunk_scan_ref(*a, 16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=SSD_ATOL, rtol=0)


@pytest.mark.parametrize("arch", list(LAYERS))
def test_launcher_trains_recurrent_families_on_cpu(arch):
    state = train.main(["--arch", arch, "--reduced", "--steps", "2",
                        "--batch", "1", "--seq", "16", "--device", "cpu"])
    assert state.step == 2 and np.isfinite(state.history[-1]["loss"])
