"""The port's dense model (``repro_torch.models.transformer``) against the
JAX package's on the same weights: JAX params and a JAX paged KV pool
are bridged into the port (``repro_torch.bridge``), then chunked prefill
into pages and the paged decode step run on both sides in fp32.

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
