"""The port's MLA serving path (deepseek-v3: MLA + MoE + a shared
expert + a leading dense-MLP layer + the MTP params) against the JAX
package's.

Same numpy-seeded inputs, JAX params bridged into the port, fp32 on the
CPU, reduced deepseek-v3 (2 layers: 1 dense-MLP, 1 MoE):

* ``flash_attention_ref`` (the plain version the port's CPU path runs
  and the CUDA kernel is held to) at a q/k head dim that differs from
  the v head dim, against ``repro.models.flash.flash_attention``
  (the reference's Pallas flash has one head dim and cannot take it),
  at the reduced widths (48/32) and at deepseek's (192/128): 1e-5.
* ``mla_fwd`` with its latent cache, ``mla_decode`` (per-slot and
  scalar positions), ``mla_paged_prefill`` and ``mla_paged_decode``:
  outputs and written latents within 1e-4 (XLA and PyTorch sum the
  latent einsums in other orders).
* the whole model: ``forward`` (and its overflow count under a bound),
  then identical greedy tokens through ``ServingEngine`` and the paged
  and contiguous ``ContinuousEngine``.
* ``bridge`` carries the MTP params bit for bit and refuses a tree
  without them (or with them for a config without MTP)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.flash import flash_attention as j_flash  # noqa: E402
from repro.serving.batching import Request as JRequest  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

ARCH = "deepseek-v3-671b"
F32 = dict(param_dtype="float32", activation_dtype="float32")
ATOL = 1e-4
MAX_SEQ = 64
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


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = j_reduced(ARCH).with_(**F32), t_reduced(ARCH).with_(**F32)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("S,H,D,Dv", [(24, 4, 48, 32), (70, 2, 192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_version_at_split_head_dims(S, H, D, Dv, causal):
    rng = np.random.default_rng(S)
    q, k = (rng.standard_normal((2, S, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, S, H, Dv)).astype(np.float32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
    assert got.shape == (2, S, H, Dv)
    _close(got, want, atol=1e-5)


def _layer(jparams, tparams, stack="blocks_moe"):
    jp = jax.tree.map(lambda a: a[0], jparams[stack])["attn"]
    tp = T.layer_params(tparams[stack], 0)["attn"]
    return jp, tp


def _x(B, S, d, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((B, S, d))
            ).astype(np.float32)


def test_mla_fwd_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    jp, tp = _layer(jparams, tparams)
    B, S = 2, 20
    x = _x(B, S, tcfg.d_model, 1)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    wo, (wckv, wkr) = JA.mla_fwd(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 return_cache=True)
    go, (gckv, gkr) = A.mla_fwd(tp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos), return_cache=True)
    _close(go, wo)
    _close(gckv, wckv)
    _close(gkr, wkr)
    r, rope = tcfg.mla.kv_lora_rank, tcfg.mla.qk_rope_head_dim
    xt = _x(B, 1, tcfg.d_model, 2)
    for p in (S, np.array([S, 7], np.int32)):       # scalar, per slot
        jc = (jnp.zeros((B, MAX_SEQ, r)).at[:, :S].set(wckv),
              jnp.zeros((B, MAX_SEQ, rope)).at[:, :S].set(wkr))
        tc = [torch.zeros((B, MAX_SEQ, w)) for w in (r, rope)]
        tc[0][:, :S], tc[1][:, :S] = gckv, gkr
        wo, wc0, wc1 = JA.mla_decode(jp, jcfg, jnp.asarray(xt), *jc,
                                     jnp.asarray(p))
        go, gc0, gc1 = A.mla_decode(tp, tcfg, torch.from_numpy(xt), *tc,
                                    torch.as_tensor(p))
        _close(go, wo)
        _close(gc0, wc0)
        _close(gc1, wc1)


def test_mla_paged_prefill_and_decode_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    jp, tp = _layer(jparams, tparams, "blocks_dense")
    r, rope = tcfg.mla.kv_lora_rank, tcfg.mla.qk_rope_head_dim
    ps, n_pages = 8, 10
    jpool = (jnp.zeros((n_pages, ps, r)), jnp.zeros((n_pages, ps, rope)))
    tpool = [torch.zeros((n_pages, ps, w)) for w in (r, rope)]
    bt = np.array([[3, 7, 1, 0]], np.int32)
    # two chunks of one sequence (13 real of 16, then 6 real of 8)
    for off, C, nv, seed in ((0, 16, 13, 3), (13, 8, 6, 4)):
        x = _x(1, C, tcfg.d_model, seed)
        wo, *jpool = JA.mla_paged_prefill(jp, jcfg, jnp.asarray(x), *jpool,
                                          off, nv, jnp.asarray(bt))
        go, *tpool = A.mla_paged_prefill(tp, tcfg, torch.from_numpy(x),
                                         *tpool, off, nv,
                                         torch.from_numpy(bt))
        _close(go[:, :nv], np.asarray(wo)[:, :nv])
    for j, g in zip(jpool, tpool):
        _close(g[[3, 7, 1]], np.asarray(j)[[3, 7, 1]])
    # a batched paged decode: the sequence above at 19, an idle slot
    bt2 = np.array([[3, 7, 1, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([19, 0], np.int32)
    x = _x(2, 1, tcfg.d_model, 5)
    wo, *jpool = JA.mla_paged_decode(jp, jcfg, jnp.asarray(x), *jpool,
                                     jnp.asarray(pos), jnp.asarray(bt2))
    go, *tpool = A.mla_paged_decode(tp, tcfg, torch.from_numpy(x), *tpool,
                                    torch.from_numpy(pos),
                                    torch.from_numpy(bt2))
    _close(go[0], np.asarray(wo)[0])
    for j, g in zip(jpool, tpool):
        _close(g[[3, 7, 1]], np.asarray(j)[[3, 7, 1]])


def test_forward_logits_and_latent_cache_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = np.random.default_rng(1).integers(1, 512, (2, 24)).astype(np.int32)
    for kw in (dict(), dict(moe_drop_free=True, moe_capacity=8)):
        want, waux, wcache = JT.forward(jparams, jcfg,
                                        {"tokens": jnp.asarray(tok)},
                                        return_cache=True, remat=False, **kw)
        got, gaux, gcache = T.forward(tparams, tcfg,
                                      {"tokens": torch.from_numpy(tok)},
                                      return_cache=True, **kw)
        _close(got, want)
        assert float(gaux) == pytest.approx(float(waux), rel=1e-6)
        assert sorted(gcache) == sorted(wcache) == ["blocks_dense",
                                                    "blocks_moe"]
        for name in wcache:
            assert sorted(gcache[name]) == ["ckv", "krope"]
            for leaf in ("ckv", "krope"):
                _close(gcache[name][leaf], wcache[name][leaf])


def _trace_prompts(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n, _, _ in TRACE]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_continuous_engine_tokens_match_jax(pair, layout):
    jcfg, tcfg, jparams, tparams = pair
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
    assert eng.kv_cache_stats()["kv_cache_bytes"] > 0


def test_serving_engine_tokens_match_jax(pair):
    jcfg, tcfg, jparams, tparams = pair
    tok = np.random.default_rng(4).integers(1, 512, (3, 12)).astype(np.int32)
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(tok, max_new=5)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(tok,
                                                                 max_new=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    _close(got.logits_last, want.logits_last)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_bridge_carries_the_mtp_params(pair):
    jcfg, tcfg, jparams, tparams = pair
    jm = jax.device_get(jparams["mtp"])
    assert sorted(tparams["mtp"]) == sorted(jm) == [
        "block", "final_norm", "norm_e", "norm_h", "proj"]
    for path in (("proj",), ("block", "attn", "w_uq"),
                 ("block", "mlp", "w_gate"), ("norm_h", "scale")):
        g, w = tparams["mtp"], jm
        for k in path:
            g, w = g[k], w[k]
        assert torch.equal(_bits(g), _bits(torch.from_numpy(np.array(w))))
    assert tparams["mtp"]["block"]["mlp"]["w_gate"].shape[-1] \
        == tcfg.moe.dense_d_ff
    tree = jax.device_get(jparams)
    with pytest.raises(ValueError, match="mtp"):
        params_from_numpy({k: v for k, v in tree.items() if k != "mtp"},
                          tcfg, device="cpu")
    with pytest.raises(ValueError, match="mtp"):
        params_from_numpy(tree, tcfg.with_(use_mtp=False), device="cpu")
    # random init has the same tree as the reference's
    init = T.init_params(tcfg, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)
    got = {}

    def walk(d, out):
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = {}
                walk(v, out[k])
            else:
                out[k] = tuple(v.shape)
    walk(init, got)
    assert got == shapes


@pytest.mark.parametrize("extra", [[], ["--continuous"]])
def test_launcher_serves_the_reduced_arch_on_cpu(capsys, extra):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt-len", "9", "--max-new", "3", "--max-seq",
                "32", *extra])
    assert "escalate=" in capsys.readouterr().out
