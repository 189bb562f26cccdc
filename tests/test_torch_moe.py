"""The port's MoE serving path (qwen3-moe) against the JAX package's.

Same numpy-seeded inputs, JAX params bridged into the port, fp32 on the
CPU:

* ``moe_fwd``, einsum and scatter dispatch, with and without
  ``drop_free`` and a capacity bound: y within 1e-5 and the aux equal
  (the overflow count under a bound must match exactly, so the same
  routings overflow); ``initial_capacity``; the twins of
  tests/test_paged_kv.py's capacity tests (overflow channel, dynamic
  capacity prefill == unbounded drop-free).  A 16-expert top-4 cut of
  the reduced config makes tight bounds overflow (the reduced config's
  4 experts never do).  Both dispatches under autograd: y, the aux and
  every gradient against ``jax.grad`` of the reference's.
* ``_route``: the same top-k experts in the same order.  Routings whose
  k-th and (k+1)-th probabilities lie within 1e-6 (where float rounding
  may swap them) are counted and reported apart; a mismatch outside
  them fails.
* reduced qwen3-moe: ``forward``, ``decode_step`` and ``prefill_chunk``
  logits within 1e-4 (XLA and PyTorch sum in other orders through the
  layers), and identical greedy tokens through ``ServingEngine`` and the
  paged and contiguous ``ContinuousEngine`` on the 16-expert cut, where
  the capacity doubling loop retries.
* ``bridge`` refuses a tree of the wrong family."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import MoEConfig as JMoE  # noqa: E402
from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import (params_from_numpy,  # noqa: E402
                                tree_from_numpy)
from repro_torch.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

ARCH = "qwen3-moe-30b-a3b"
F32 = dict(param_dtype="float32", activation_dtype="float32")
ATOL = 1e-4
Y_ATOL = 1e-5
NEAR_TIE = 1e-6
MAX_SEQ = 64
WIDE = dict(n_experts=16, experts_per_token=4, d_expert=64)
TRACE = [(5, 6, 0.0), (40, 4, 0.0), (17, 5, 1.0), (30, 3, 2.0),
         (9, 7, 2.0)]                                  # (len, max_new, t)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(wide: bool):
    jcfg, tcfg = j_reduced(ARCH).with_(**F32), t_reduced(ARCH).with_(**F32)
    if wide:
        jcfg = jcfg.with_(moe=JMoE(**WIDE))
        tcfg = tcfg.with_(moe=TMoE(**WIDE))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair(wide=False)


@pytest.fixture(scope="module")
def wide():
    return _pair(wide=True)


def _layer0(jparams, tparams):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks_moe"])["moe"]
    tp = T.layer_params(tparams["blocks_moe"], 0)["moe"]
    return jp, tp


def _x(T_, d, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal((1, T_, d))
            ).astype(np.float32)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("drop_free,capacity", [(False, None), (True, None),
                                                (True, 4), (True, 8),
                                                (True, 64)])
def test_moe_fwd_matches_jax(wide, dispatch, drop_free, capacity):
    jcfg, tcfg, jparams, tparams = wide
    jp, tp = _layer0(jparams, tparams)
    x = _x(24, tcfg.d_model)
    wy, waux = JM.moe_fwd(jp, jcfg, jnp.asarray(x), dispatch=dispatch,
                          drop_free=drop_free, capacity=capacity)
    gy, gaux = M.moe_fwd(tp, tcfg, torch.from_numpy(x), dispatch=dispatch,
                         drop_free=drop_free, capacity=capacity)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=Y_ATOL,
                               rtol=0)
    if capacity is not None:
        assert float(gaux) == float(waux)          # overflow counts
    else:
        assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
    if capacity == 4:
        assert float(gaux) > 0, "the tight bound should overflow"


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_fwd_gradients_match_jax(wide, dispatch):
    """Both dispatches under autograd (the scatter one writes a fresh
    buffer with ``index_add_``), routing with capacity as in training: y,
    the load-balance aux and the gradients of the input and of every
    MoE leaf (router and experts) against ``jax.grad`` of the
    reference's ``moe_fwd``.  Tolerance: atol 1e-5 of each tensor's
    largest magnitude (the stacked experts take fan-in E, so |y| reaches
    hundreds at unit inputs), the aux within 1e-6 relative."""
    jcfg, tcfg, jparams, tparams = wide
    jp, tp = _layer0(jparams, tparams)
    tp = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tp.items()}
    x = _x(24, tcfg.d_model, seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_fwd(p, jcfg, x, dispatch=dispatch)
        return jnp.sum(y * w) + aux, (y, aux)
    (_, (wy, waux)), (wgp, wgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    gy, gaux = M.moe_fwd(tp, tcfg, tx, dispatch=dispatch)
    ((gy * torch.from_numpy(w)).sum() + gaux).backward()
    assert float(gaux.detach()) == pytest.approx(float(waux), rel=1e-6)
    got = {"y": gy.detach().numpy(), "x": tx.grad.numpy()}
    want = {"y": np.asarray(wy), "x": np.asarray(wgx)}
    for k, v in tp.items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [("", v)]):
            got[k + kk] = leaf.grad.numpy()
            ww = wgp[k][kk] if kk else wgp[k]
            want[k + kk] = np.asarray(ww)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, err_msg=k,
                                   atol=1e-5 * np.abs(v).max())


def test_moe_capacity_overflow_channel(wide):
    """tests/test_paged_kv.py's twin on the port: a tight bound gives the
    exact result or reports its overflow; a bound of every token gives
    the exact result with 0 overflow."""
    _, cfg, _, params = wide
    p = T.layer_params(params["blocks_moe"], 0)["moe"]
    x = torch.from_numpy(_x(16, cfg.d_model, seed=2) * 0.2)
    y_exact, _ = M.moe_fwd(p, cfg, x, drop_free=True)
    y_cap, aux = M.moe_fwd(p, cfg, x, drop_free=True, capacity=4)
    if float(aux) == 0.0:
        torch.testing.assert_close(y_cap, y_exact, atol=1e-6, rtol=0)
    else:
        assert float(aux) > 0
    y_full, aux_full = M.moe_fwd(p, cfg, x, drop_free=True, capacity=16)
    assert float(aux_full) == 0.0
    torch.testing.assert_close(y_full, y_exact, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_tok", [1, 7, 16, 100, 4096])
def test_initial_capacity_matches_jax(wide, n_tok):
    jcfg, tcfg, _, _ = wide
    assert M.initial_capacity(tcfg, n_tok) == JM.initial_capacity(jcfg,
                                                                  n_tok)
    cap = M.initial_capacity(tcfg, n_tok)
    assert cap <= n_tok and (cap % 4 == 0 or cap == n_tok)


def test_route_picks_the_same_experts(wide):
    """Same experts in the same order (a tie goes to the lower index, as
    jax.lax.top_k orders it); near-ties at the k-th place counted."""
    jcfg, tcfg, jparams, tparams = wide
    jp, tp = _layer0(jparams, tparams)
    x = _x(256, tcfg.d_model, seed=3)[0]
    wp, we, _, wprobs = JM._route(jp, jcfg, jnp.asarray(x))
    gp, ge, _, _ = M._route(tp, tcfg, torch.from_numpy(x))
    k = tcfg.moe.experts_per_token
    srt = np.sort(np.asarray(wprobs), axis=-1)[:, ::-1]
    near = np.abs(srt[:, k - 1] - srt[:, k]) < NEAR_TIE
    same = (ge.numpy() == np.asarray(we)).all(-1)
    assert not (~same & ~near).any(), np.nonzero(~same & ~near)
    print(f"route: {int(same.sum())} identical, {int((~same).sum())} at "
          f"near-ties, {int(near.sum())} near-ties in all")
    np.testing.assert_allclose(gp.numpy()[same], np.asarray(wp)[same],
                               atol=1e-6)
    # planted exact ties: every expert equally likely
    tie = {"router": torch.zeros_like(tp["router"])}
    _, te, _, _ = M._route(tie, tcfg, torch.from_numpy(x[:4]))
    _, je, _, _ = JM._route({"router": jnp.zeros(tie["router"].shape)},
                            jcfg, jnp.asarray(x[:4]))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_forward_decode_and_chunk_logits_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = np.random.default_rng(1).integers(1, 512, (2, 24)).astype(np.int32)
    for kw in (dict(), dict(moe_drop_free=True, moe_capacity=8)):
        want, waux, wcache = JT.forward(jparams, jcfg,
                                        {"tokens": jnp.asarray(tok)},
                                        return_cache=True, remat=False, **kw)
        got, gaux, gcache = T.forward(tparams, tcfg,
                                      {"tokens": torch.from_numpy(tok)},
                                      return_cache=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(gcache["blocks_moe"][leaf].numpy(),
                                       np.asarray(wcache["blocks_moe"][leaf]),
                                       atol=ATOL)
    # decode on the prefill's cache, per-slot positions
    jc = JT.graft_slot_cache(JT.init_cache(jcfg, 2, MAX_SEQ), wcache, 0)
    tc = T.graft_slot_cache(T.init_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                            tree_from_numpy(jax.device_get(wcache), "cpu"), 0)
    nt = np.array([[3], [5]], np.int32)
    pos = np.array([24, 24], np.int32)
    wl, _ = JT.decode_step(jparams, jcfg, jc, jnp.asarray(nt),
                           jnp.asarray(pos))
    gl, _ = T.decode_step(tparams, tcfg, tc, torch.from_numpy(nt),
                          torch.from_numpy(pos))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=ATOL)
    # a chunk into pages under a tight bound: logits and overflow count
    jpool = JT.init_paged_cache(jcfg, 8, 8)
    tpool = T.init_paged_cache(tcfg, 8, 8, device="cpu")
    bt = np.array([[1, 2, 3, 4]], np.int32)
    wl, wo, jpool = JT.prefill_chunk(jparams, jcfg, jpool,
                                     jnp.asarray(tok[:1, :16]), 13, 0,
                                     jnp.asarray(bt), moe_capacity=4)
    gl, go, tpool = T.prefill_chunk(tparams, tcfg, tpool,
                                    torch.from_numpy(tok[:1, :16]), 13, 0,
                                    torch.from_numpy(bt), moe_capacity=4)
    np.testing.assert_allclose(gl.numpy()[:, :13], np.asarray(wl)[:, :13],
                               atol=ATOL)
    assert float(go) == float(wo)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tpool["blocks_moe"][leaf].numpy()[:, 1:3],
                                   np.asarray(jpool["blocks_moe"][leaf])
                                   [:, 1:3], atol=ATOL)


def _trace_prompts(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n, _, _ in TRACE]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_continuous_engine_tokens_match_jax(wide, layout):
    """On the 16-expert cut, whose chunks overflow the first capacity
    guess, so the engine's doubling loop retries."""
    jcfg, tcfg, jparams, tparams = wide
    prompts = _trace_prompts()
    kw = dict(n_slots=2, max_seq=MAX_SEQ, kv_layout=layout,
              prefill_budget_tokens=16)
    jreqs = [JRequest(prompt=p, max_new=m, arrival_t=t)
             for p, (_, m, t) in zip(prompts, TRACE)]
    jres = JEngine(jcfg, jparams, **kw).run(jreqs)
    eng = ContinuousEngine(tcfg, tparams, **kw)
    treqs = [Request(prompt=p, max_new=m, arrival_t=t)
             for p, (_, m, t) in zip(prompts, TRACE)]
    tres = eng.run(treqs)
    for jr, tr in zip(jreqs, treqs):       # each package numbers its own
        np.testing.assert_array_equal(tres[tr.rid].tokens,
                                      jres[jr.rid].tokens)
    assert eng.moe_overflows, "the 16-expert cut should retry"
    assert all(n > 0 for n in eng.moe_overflows)


def test_serving_engine_tokens_match_jax(wide):
    jcfg, tcfg, jparams, tparams = wide
    tok = np.random.default_rng(4).integers(1, 512, (2, 40)).astype(np.int32)
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(tok, max_new=5)
    eng = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ)
    got = eng.generate(tok, max_new=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits_last, want.logits_last, atol=ATOL)
    assert eng.moe_overflows


def test_dynamic_capacity_prefill_equals_drop_free(wide):
    """The engine's doubling loop from initial_capacity lands on the
    unbounded drop-free logits (tests/test_paged_kv.py's twin), after at
    least one retry on this cut."""
    _, cfg, _, params = wide
    eng = ContinuousEngine(cfg, params, n_slots=1, max_seq=MAX_SEQ,
                           kv_layout="contiguous")
    toks = np.random.default_rng(4).integers(1, 512, (1, 64)) \
        .astype(np.int32)
    dyn, _ = eng._run_prefill(toks)
    exact, _, _ = T.forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                            moe_drop_free=True, return_cache=True)
    torch.testing.assert_close(dyn, exact, atol=1e-6, rtol=0)
    assert eng.moe_overflows


def test_bridge_refuses_a_tree_of_the_wrong_family(pair):
    jcfg, tcfg, jparams, _ = pair
    tree = jax.device_get(jparams)
    dense = jax.device_get(JT.init_params(
        jax.random.PRNGKey(0), jcfg.with_(family="dense", moe=None)))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(dense, tcfg, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, t_reduced("deepseek-v3-671b").with_(**F32),
                          device="cpu")
    wrong = tcfg.with_(moe=TMoE(n_experts=8, experts_per_token=2,
                                d_expert=128))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, wrong, device="cpu")
    bf = {**tree, "blocks_moe": {**tree["blocks_moe"], "moe": {
        **tree["blocks_moe"]["moe"],
        "router": tree["blocks_moe"]["moe"]["router"].astype(jnp.bfloat16)}}}
    with pytest.raises(ValueError, match="router: dtype"):
        params_from_numpy(bf, tcfg, device="cpu")


@pytest.mark.parametrize("extra", [[], ["--continuous"]])
def test_launcher_serves_the_reduced_arch_on_cpu(capsys, extra):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "9", "--max-new", "3", "--max-seq",
                "32", *extra])
    assert "escalate=" in capsys.readouterr().out
