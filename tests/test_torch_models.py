"""The port's dense model (``repro_torch.models.transformer``) against the
JAX package's on the same weights: JAX params and JAX KV caches (a paged
pool, a contiguous cache) are bridged into the port
(``repro_torch.bridge``), then chunked prefill into pages and the paged
decode step, the monolithic forward with its cache, and the contiguous
decode step (scalar, per-slot and ring-buffer positions) run on both
sides in fp32.

Tolerance: logits atol 1e-4 and pools atol 1e-5.  Both sides run the
same fp32 arithmetic, but matmul and softmax sums are taken in another
order by XLA and by PyTorch's CPU kernels, so the results differ in the
last bits and the differences grow through the layers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

PS = 16
MAX_BT = 4                                   # max_seq 64
ARCHS = ["smollm-360m", "tiansuan_pair"]     # reduced: tiansuan ONBOARD


def _f32(cfg):
    return cfg.with_(param_dtype="float32", activation_dtype="float32")


def _setup(arch, seed=0):
    jcfg, tcfg = _f32(j_reduced(arch)), _f32(t_reduced(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg, max_seq=64)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    # a pool full of stale data: only what the tables and lengths select
    # may reach the outputs
    rng = np.random.default_rng(seed)
    pool = jax.device_get(JT.init_paged_cache(jcfg, 10, PS))
    pool = {"blocks": {k: rng.standard_normal(v.shape).astype(np.float32)
                       for k, v in pool["blocks"].items()}}
    jpool = jax.tree.map(jnp.asarray, pool)
    tpool = tree_from_numpy(pool, device="cpu")
    return jcfg, tcfg, jparams, tparams, jpool, tpool, rng


def _close_pools(jpool, tpool):
    for k in ("k", "v"):
        np.testing.assert_allclose(tpool["blocks"][k].numpy(),
                                   np.asarray(jpool["blocks"][k]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunks_then_paged_decode_match_jax(arch):
    jcfg, tcfg, jparams, tparams, jpool, tpool, rng = _setup(arch)
    V = tcfg.vocab_size
    prompt = rng.integers(1, V, 21).astype(np.int32)
    bt = np.zeros((1, MAX_BT), np.int32)
    bt[0, :2] = [7, 3]                       # non-contiguous pages
    # two chunks, bucketed as the engine buckets them: 16 real tokens,
    # then 5 real tokens padded to 8 (pads write to the scratch page)
    for off, n, width in ((0, 16, 16), (16, 5, 8)):
        toks = np.zeros((1, width), np.int32)
        toks[0, :n] = prompt[off:off + n]
        jl, _, jpool = JT.prefill_chunk(jparams, jcfg, jpool,
                                        jnp.asarray(toks), n, off,
                                        jnp.asarray(bt))
        tl, aux, tpool = TT.prefill_chunk(tparams, tcfg, tpool,
                                          torch.from_numpy(toks), n, off,
                                          torch.from_numpy(bt))
        assert tl.shape == (1, width, V) and tl.dtype == torch.float32
        assert float(aux) == 0.0
        np.testing.assert_allclose(tl.numpy()[0, :n], np.asarray(jl)[0, :n],
                                   atol=1e-4, rtol=0)
    _close_pools(jpool, tpool)

    # three decode slots: the prefilled sequence, an idle slot (all
    # scratch, position 0) and a sequence ending mid-page in page 5
    bts = np.zeros((3, MAX_BT), np.int32)
    bts[0, :2] = [7, 3]
    bts[2, :1] = [5]
    toks = np.asarray([[int(prompt[-1])], [0], [11]], np.int32)
    for step in range(3):
        pos = np.asarray([21 + step, 0, 9 + step], np.int32)
        jl, jpool = JT.decode_step(jparams, jcfg, jpool, jnp.asarray(toks),
                                   jnp.asarray(pos),
                                   block_tables=jnp.asarray(bts))
        tl, tpool = TT.decode_step(tparams, tcfg, tpool,
                                   torch.from_numpy(toks),
                                   torch.from_numpy(pos),
                                   block_tables=torch.from_numpy(bts))
        assert tl.shape == (3, 1, V)
        np.testing.assert_allclose(tl.numpy()[[0, 2]], np.asarray(jl)[[0, 2]],
                                   atol=1e-4, rtol=0)
        toks = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
    _close_pools(jpool, tpool)


def test_bridge_bf16_params_are_bit_exact():
    jcfg, tcfg = j_reduced("tiansuan_pair"), t_reduced("tiansuan_pair")
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(1), jcfg))
    p = params_from_numpy(tree, tcfg, device="cpu")
    leaves = [("embed",), ("blocks", "attn", "w_q"), ("blocks", "mlp", "w_up"),
              ("final_norm", "scale")]
    for path in leaves:
        a, t = tree, p
        for k in path:
            a, t = a[k], t[k]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    with pytest.raises(ValueError):
        params_from_numpy(tree, _f32(tcfg), device="cpu")   # dtype mismatch


def _stale_cache(jcfg, B, max_seq, rng):
    """A contiguous cache full of stale data, as (JAX, port) twins."""
    c = jax.device_get(JT.init_cache(jcfg, B, max_seq))
    c = {"blocks": {k: rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in c["blocks"].items()}}
    return jax.tree.map(jnp.asarray, c), tree_from_numpy(c, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_cache_match_jax(arch):
    jcfg, tcfg, jparams, tparams, _, _, rng = _setup(arch)
    toks = rng.integers(0, tcfg.vocab_size, (2, 19)).astype(np.int32)
    jl, jaux, jc = JT.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                              return_cache=True, remat=False)
    tl, taux, tc = TT.forward(tparams, tcfg,
                              {"tokens": torch.from_numpy(toks)},
                              return_cache=True)
    assert tl.shape == (2, 19, tcfg.vocab_size) and float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for k in ("k", "v"):
        assert tc["blocks"][k].shape == (tcfg.n_layers, 2, 19,
                                         tcfg.n_kv_heads,
                                         tcfg.resolved_head_dim)
        np.testing.assert_allclose(tc["blocks"][k].numpy(),
                                   np.asarray(jc["blocks"][k]), atol=1e-5,
                                   rtol=0)
    pl, pc = TT.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(pl.numpy(), tl.numpy()[:, -1:], atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["scalar", "per_slot", "ring"])
def test_contiguous_decode_step_matches_jax(arch, kind):
    """Three decode steps on a stale contiguous cache: every sequence at
    one position (fixed-slot), each at its own (continuous batching),
    and per-slot positions that wrap a 16-position ring buffer."""
    jcfg, tcfg, jparams, tparams, _, _, rng = _setup(arch)
    if kind == "ring":
        jcfg = jcfg.with_(sliding_window=16)
        tcfg = tcfg.with_(sliding_window=16)
    jc, tc = _stale_cache(jcfg, 3, 64, rng)
    assert tc["blocks"]["k"].shape[2] == (16 if kind == "ring" else 64)
    toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
    for step in range(3):
        if kind == "scalar":
            pos = np.int32(21 + step)
        else:
            pos = np.asarray([21, 0, 40], np.int32) + step
        jl, jc = JT.decode_step(jparams, jcfg, jc, jnp.asarray(toks),
                                jnp.asarray(pos))
        tl, tc = TT.decode_step(tparams, tcfg, tc, torch.from_numpy(toks),
                                torch.from_numpy(np.asarray(pos)))
        assert tl.shape == (3, 1, tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        toks = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][k].numpy(),
                                   np.asarray(jc["blocks"][k]), atol=1e-5,
                                   rtol=0)


def test_bridge_contiguous_bf16_cache_is_bit_exact():
    jcfg = j_reduced("tiansuan_pair")
    jparams = JT.init_params(jax.random.PRNGKey(2), jcfg, max_seq=64)
    toks = jnp.asarray(np.arange(1, 12, dtype=np.int32)[None])
    _, _, small = JT.forward(jparams, jcfg, {"tokens": toks},
                             return_cache=True, remat=False)
    cache = jax.device_get(JT.graft_slot_cache(JT.init_cache(jcfg, 2, 32),
                                               small, jnp.int32(1)))
    t = tree_from_numpy(cache, device="cpu")
    for k in ("k", "v"):
        a = np.asarray(cache["blocks"][k])
        assert a.shape == (jcfg.n_layers, 2, 32, jcfg.n_kv_heads,
                           jcfg.resolved_head_dim)
        assert t["blocks"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(t["blocks"][k].view(torch.int16).numpy(),
                                      a.view(np.int16))
        assert np.any(a.view(np.int16) != 0)
