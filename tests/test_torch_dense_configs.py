"""The dense configs granite-20b, granite-34b and qwen1.5-4b in the port
against the JAX package, and flash's plain version at their wide GQA
groups.

* The configs: ``get_config`` / ``get_reduced_config`` of the dense
  configs, xlstm-1.3b, whisper-tiny and qwen2-vl-2b equal the JAX
  package's field for field.
* Reduced granite-20b / granite-34b (MQA, the biased GELU MLP) and
  qwen1.5-4b (``qkv_bias``, full MHA) in fp32 on bridged weights:
  ``forward`` logits, then greedy tokens through ``ServingEngine``
  (monolithic prefill, contiguous decode) and the paged
  ``ContinuousEngine`` (chunked prefill, paged decode) against the
  reference's engines.
* ``kernels/ref.py::flash_attention_ref`` (what ``ops.flash_attention``
  runs on a CPU tensor) at granite's group of 48 query heads over one
  KV head and at g = 12, against ``repro.models.flash.flash_attention``;
  and the CUDA kernel's cut of a wide group into slices
  (``group_slice``): the plain version run slice by slice, each slice's
  query heads against its one KV head, gives the whole.

Tolerances: logits atol 1e-4 (the same fp32 arithmetic, sums in another
order by XLA and by PyTorch's CPU kernels; seen ~5e-6); flash outputs
atol 1e-5 (seen ~1e-6); tokens identical; the slice-by-slice plain
version equals the whole one bit for bit (the same per-row arithmetic)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as j_config  # noqa: E402
from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import flash as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.batching import poisson_trace as j_trace  # noqa: E402
from repro.serving.engine import ContinuousEngine as JEngine  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config as t_config  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import group_slice  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.batching import poisson_trace  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        ServingEngine)
from torch_inputs import attention_inputs  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
DENSE = ["granite-20b", "granite-34b", "qwen1.5-4b"]
NEW_ARCHS = DENSE + ["xlstm-1.3b", "whisper-tiny", "qwen2-vl-2b"]
ATOL = 1e-4
FLASH_ATOL = 1e-5
MAX_SEQ = 64
# (B, S, H, Hkv, D): granite's 48/1 group at a small width and length,
# and a group of 12
WIDE_GROUPS = [(1, 40, 48, 1, 32), (2, 33, 24, 2, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, tcfg = j_reduced(arch).with_(**F32), t_reduced(arch).with_(**F32)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference(arch):
    assert dataclasses.asdict(t_config(arch)) == \
        dataclasses.asdict(j_config(arch))
    assert dataclasses.asdict(t_reduced(arch)) == \
        dataclasses.asdict(j_reduced(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    tok = np.random.default_rng(1).integers(1, jcfg.vocab_size, (2, 24)) \
        .astype(np.int32)
    want, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t}))(
        jparams, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(tok)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_jax_through_both_engines(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    prompts = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = JServing(jcfg, jparams, max_seq=MAX_SEQ).generate(prompts,
                                                             max_new=5)
    got = ServingEngine(tcfg, tparams, max_seq=MAX_SEQ).generate(prompts,
                                                                 max_new=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logits_last, want.logits_last, atol=ATOL,
                               rtol=0)
    kw = dict(rate=1.0, prompt_lens=(5, 20), max_new=(3, 5),
              vocab_size=jcfg.vocab_size, seed=3)
    jeng = JEngine(jcfg, jparams, n_slots=2, max_seq=MAX_SEQ,
                   prefill_budget_tokens=16)
    teng = ContinuousEngine(tcfg, tparams, n_slots=2, max_seq=MAX_SEQ,
                            prefill_budget_tokens=16)
    assert teng.kv_layout == jeng.kv_layout == "paged"
    jres, tres = jeng.run(j_trace(3, **kw)), teng.run(poisson_trace(3, **kw))
    assert teng.clock == jeng.clock
    for rid, jr in jres.items():
        np.testing.assert_array_equal(tres[rid].tokens, jr.tokens)


@pytest.mark.parametrize("B,S,H,Hkv,D", WIDE_GROUPS)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 8)])
def test_plain_flash_at_wide_groups_matches_jax(B, S, H, Hkv, D, causal,
                                                window):
    q, k, v = attention_inputs(B, S, H, Hkv, D, seed=H + S)
    want = JF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=causal, window=window)
    got = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, window=window)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FLASH_ATOL, rtol=0)


@pytest.mark.parametrize("g,gs", [(1, 1), (3, 3), (8, 8), (12, 6), (16, 8),
                                  (48, 8), (11, 1), (96, 8)])
def test_group_slice_is_the_largest_divisor_up_to_8(g, gs):
    assert group_slice(g) == gs


@pytest.mark.parametrize("B,S,H,Hkv,D", WIDE_GROUPS)
def test_group_slices_cover_the_heads(B, S, H, Hkv, D):
    """The kernel's mapping: grid y = H // gs slices, slice i holding
    query heads i * gs .. i * gs + gs - 1 of KV head i * gs // g.  The
    plain version run on each slice alone, against its KV head, gives
    the whole attention."""
    q, k, v = (torch.from_numpy(a) for a in attention_inputs(
        B, S, H, Hkv, D, seed=7))
    g = H // Hkv
    gs = group_slice(g)
    want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    got = torch.empty_like(want)
    got_lse = torch.empty_like(want_lse)
    for i in range(H // gs):
        heads, kv = slice(i * gs, (i + 1) * gs), i * gs // g
        o, lse = ref.flash_attention_ref(
            q[:, :, heads], k[:, :, kv:kv + 1], v[:, :, kv:kv + 1],
            return_lse=True)
        got[:, :, heads], got_lse[:, heads] = o, lse
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)
