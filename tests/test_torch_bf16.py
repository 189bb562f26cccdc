"""The port against the JAX package in bf16 (params and activations), on
the same bridged weights: reduced smollm-360m, the tiansuan ONBOARD tier
and reduced zamba2-7b (one Mamba2 unit with the shared attention block
and a tail block).  The prompt's logits through ``forward`` and the
logits of one contiguous decode step after ``prefill`` are compared.

Tolerance, measured against what bf16 itself costs: the reference's
fp32 run on the same weights (upcast) is the truth, and the reference's
own bf16 error against it, e_ref, is the yardstick.  The port's bf16
logits must be as close to the truth: max error at most 1.5 e_ref's max
and mean error at most 1.15 e_ref's mean (measured on these configs:
at most 1.24x and 1.06x), and within 2 e_ref's max of the reference's
bf16 logits.  Both sides round activations to bf16 after every matmul
and norm, but at other places (XLA fuses, PyTorch does not) and with
sums in another order.  The greedy token (argmax) must agree with the
reference's bf16 one, except where the reference's top-2 gap is within
2 e_ref's max: such near-ties are counted, and any other disagreement
fails the test."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.configs.tiansuan_pair import ONBOARD as J_ONBOARD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import ServingEngine as JServing  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.configs import tiansuan_pair as t_pair  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

MAX_SEQ = 128
F32 = dict(param_dtype="float32", activation_dtype="float32")
CONFIGS = {
    "smollm-360m": (lambda: j_reduced("smollm-360m"),
                    lambda: t_reduced("smollm-360m"), 24),
    "tiansuan-onboard": (lambda: J_ONBOARD, lambda: t_pair.ONBOARD, 24),
    # one unit of shared_attn_every Mamba2 blocks, the shared block and a
    # tail; 64-token prompts fill one SSD chunk of the reduced config
    "zamba2-7b": (lambda: j_reduced("zamba2-7b").with_(n_layers=3),
                  lambda: t_reduced("zamba2-7b").with_(n_layers=3), 64),
}


def _compare(got, want, truth, what):
    """The port's bf16 logits against the reference's bf16 and fp32
    ones (see the module's note).  Returns the near-tie count."""
    got, want, truth = (np.asarray(a, np.float32) for a in (got, want, truth))
    e_ref, e_port = np.abs(want - truth), np.abs(got - truth)
    assert e_port.max() <= 1.5 * e_ref.max(), (
        f"{what}: max error {e_port.max()} against {e_ref.max()}")
    assert e_port.mean() <= 1.15 * e_ref.mean(), (
        f"{what}: mean error {e_port.mean()} against {e_ref.mean()}")
    bound = 2 * e_ref.max()
    assert np.abs(got - want).max() <= bound, (
        f"{what}: max |port - reference| {np.abs(got - want).max()} over "
        f"{bound}")
    top2 = np.sort(want, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = got.argmax(-1) != want.argmax(-1)
    near_tie = gap <= bound
    assert not (differ & ~near_tie).any(), (
        f"{what}: argmax differs away from a near-tie (gaps "
        f"{gap[differ & ~near_tie]})")
    return int((differ & near_tie).sum())


def _decode_logits(T, cfg, params, serving, toks, nxt, wrap):
    """Logits of one contiguous decode step after ``prefill``."""
    B, S = toks.shape
    _, cache = T.prefill(params, cfg, {"tokens": wrap(toks)})
    cache = serving(cfg, params, max_seq=MAX_SEQ).full_cache(cache, B)
    return T.decode_step(params, cfg, cache, wrap(nxt), S)[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_logits_match_jax(name):
    jmake, tmake, S = CONFIGS[name]
    jcfg, tcfg = jmake(), tmake()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.param_dtype == tcfg.activation_dtype == "bfloat16"
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=MAX_SEQ)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    j32cfg = jcfg.with_(**F32)
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    B = 3
    toks = np.random.default_rng(1).integers(
        1, tcfg.vocab_size, (B, S)).astype(np.int32)

    def jrun(p, c):
        return JT.forward(p, c, {"tokens": jnp.asarray(toks)})[0]

    jl = jrun(jparams, jcfg)
    tl = TT.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)})[0]
    near = _compare(tl.float().numpy(), jl.astype(jnp.float32),
                    jrun(j32, j32cfg), f"{name} forward")

    # one decode step on the prompt's contiguous cache, fed the
    # reference's greedy token
    nxt = np.asarray(jl[:, -1].argmax(-1), np.int32)[:, None]
    got = _decode_logits(TT, tcfg, tparams, ServingEngine, toks, nxt,
                         torch.from_numpy)
    want, truth = (_decode_logits(JT, c, p, JServing, toks, nxt, jnp.asarray)
                   for p, c in ((jparams, jcfg), (j32, j32cfg)))
    near += _compare(got.float().numpy(), want.astype(jnp.float32), truth,
                     f"{name} decode step")
    # counted, not hidden: a near-tie may flip, nothing else may
    assert near <= B * (S + 1) // 10, f"{name}: {near} near-ties"
