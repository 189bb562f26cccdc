"""A dense config with the biased GELU MLP (``mlp_type="gelu"``, as
granite-20b and granite-34b set it) in the port against the JAX package,
on reduced smollm-360m in fp32 with bridged weights: the MLP alone, then
``ServingEngine.generate`` (forward prefill, contiguous decode) and the
paged ``ContinuousEngine`` (chunked prefill, paged decode).  Greedy
tokens identical, logits atol 1e-4 (the same fp32 arithmetic, sums in
another order by XLA and by PyTorch's CPU kernels).  ``jax.nn.gelu`` is
the tanh approximation by default, and so is the port's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.batching import poisson_trace as j_trace  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.batching import poisson_trace  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)

GELU_F32 = dict(mlp_type="gelu", param_dtype="float32",
                activation_dtype="float32")
ATOL = 1e-4


def _pair(seed=0, **kw):
    jcfg = j_reduced("smollm-360m").with_(**GELU_F32, **kw)
    tcfg = t_reduced("smollm-360m").with_(**GELU_F32, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg, max_seq=64)
    return jcfg, tcfg, jparams, params_from_numpy(jax.device_get(jparams),
                                                  tcfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """The layer on the same weights, with nonzero biases."""
    rng = np.random.default_rng(0)
    d, f = 48, 96
    p = {"w_up": rng.standard_normal((d, f)) / d ** 0.5,
         "b_up": rng.standard_normal(f) * 0.1,
         "w_down": rng.standard_normal((f, d)) / f ** 0.5,
         "b_down": rng.standard_normal(d) * 0.1}
    x = rng.standard_normal((2, 5, d)) * 2.0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(jp[k].astype(jnp.float32)))
          .to(tdt) for k in p}
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    want = np.asarray(JL.gelu_mlp(jp, jx).astype(jnp.float32))
    got = TL.gelu_mlp(tp, tx)
    assert got.dtype == tdt
    # bf16: the same bf16 products, which may round at other places:
    # within two bf16 ulps of |y| (up to ~6, an ulp of 2**-5 there)
    atol = 1e-5 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_gelu_config_builds_and_bridges_the_gelu_tree():
    jcfg, tcfg, jparams, tparams = _pair()
    mlp = tparams["blocks"]["mlp"]
    assert set(mlp) == {"w_up", "b_up", "w_down", "b_down"}
    own = TT.init_params(tcfg, seed=0, device="cpu")["blocks"]["mlp"]
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in mlp.items()}


def test_params_from_numpy_refuses_the_other_mlp_kind():
    """A SwiGLU tree for a GELU config, and a GELU tree for a SwiGLU
    config, are refused (the shapes of w_up and w_down alone match)."""
    gelu_j, gelu_t, gelu_params, _ = _pair()
    swiglu_j = gelu_j.with_(mlp_type="swiglu")
    swiglu_t = gelu_t.with_(mlp_type="swiglu")
    swiglu_params = JT.init_params(jax.random.PRNGKey(0), swiglu_j,
                                   max_seq=64)
    with pytest.raises(ValueError, match="mlp"):
        params_from_numpy(jax.device_get(swiglu_params), gelu_t,
                          device="cpu")
    with pytest.raises(ValueError, match="mlp"):
        params_from_numpy(jax.device_get(gelu_params), swiglu_t,
                          device="cpu")


def test_gelu_config_generate_matches_jax():
    """Forward prefill and contiguous decode: identical greedy tokens,
    prompt and final logits within ATOL."""
    jcfg, tcfg, jparams, tparams = _pair()
    prompts = np.random.default_rng(3).integers(
        1, tcfg.vocab_size, (3, 13)).astype(np.int32)
    want = JServing(jcfg, jparams, max_seq=64).generate(prompts, max_new=7)
    got = ServingEngine(tcfg, tparams, max_seq=64).generate(prompts,
                                                            max_new=7)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.prompt_logits, want.prompt_logits,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.logits_last, want.logits_last, atol=ATOL,
                               rtol=0)


def test_gelu_config_paged_engine_matches_jax():
    """Chunked prefill into pages and paged decode through the
    continuous engine: identical greedy tokens and final logits."""
    jcfg, tcfg, jparams, tparams = _pair()
    kw = dict(n_slots=3, max_seq=64, prefill_budget_tokens=16)
    trace = dict(rate=0.6, prompt_lens=(3, 30), max_new=(1, 9),
                 vocab_size=tcfg.vocab_size, seed=5)
    jreqs, treqs = j_trace(6, **trace), poisson_trace(6, **trace)
    jres = JEngine(jcfg, jparams, **kw).run(jreqs)
    tres = ContinuousEngine(tcfg, tparams, **kw).run(treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tres[tr.rid].tokens,
                                      jres[jr.rid].tokens)
        np.testing.assert_allclose(tres[tr.rid].logits_last,
                                   jres[jr.rid].logits_last, atol=ATOL,
                                   rtol=0)
