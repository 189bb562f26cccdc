"""The port's flash attention under autograd (``repro_torch.models.flash``:
the forward's log-sum-exp and the plain-PyTorch twin of the reference's
flash backward) against ``jax.grad`` of the JAX package's
``repro.models.flash.flash_attention`` on the same numpy inputs, in fp32:
GQA groups 1, 2 and 3, causal, non-causal and a window of 16, lengths
that are not a multiple of the 128-row block, and MLA's split head dims
(q/k 192, v 128).  On the CPU the forward is the plain version; the card
runs the kernel (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: atol 2e-5, rtol 1e-4 on out, dq, dk, dv and lse.  Both sides
compute the same fp32 arithmetic blocked the same way in the backward;
the forward here is the plain softmax against the reference's online
one, and sums run in another order, so they differ in the last bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import flash as JF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import flash as TF  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
# (B, S, H, Hkv, D, Dv): groups 1, 2 and 3; S = 200 and 130 span two
# 128-row blocks with a ragged edge (one 256-row block each: bq = min(1024,
# ceil128(S))); MLA's (192, 128) at two heads
SHAPES = [(2, 200, 4, 4, 16, 16), (1, 130, 4, 2, 32, 32),
          (2, 77, 6, 2, 16, 16), (1, 140, 2, 2, 192, 128)]
MASKS = [(True, 0), (False, 0), (True, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, Hkv, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv),
                      (B, S, H, Dv))]


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_grads_match_reference(shape, causal, window):
    q, k, v, do = _inputs(*shape)

    def jloss(q, k, v):
        o = JF.flash_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * do), o
    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = TF.flash_attention(tq, tk, tv, causal=causal, window=window)
    (to * torch.from_numpy(do)).sum().backward()
    _close(to, jo)
    for got, want in zip((tq, tk, tv), jg):
        _close(got.grad, want)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_lse_matches_reference_forward(shape, causal, window):
    """The plain version's lse (what the CPU forward saves) against the
    rows' lse of the reference's ``_flash_fwd_impl``, (B, Hkv, g, S)
    read as (B, H, S)."""
    B, S, H, Hkv, D, Dv = shape
    q, k, v, _ = _inputs(*shape, seed=1)
    g = H // Hkv
    cfg = (causal, 0, window, 256, 256)
    jo, jl = JF._flash_fwd_impl(cfg, jnp.asarray(q.reshape(B, S, Hkv, g, D)),
                                jnp.asarray(k), jnp.asarray(v), jnp.int32(S))
    to, tl = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, window=window,
                                 return_lse=True)
    assert tl.shape == (B, H, S) and tl.dtype == torch.float32
    _close(tl, np.asarray(jl).reshape(B, H, S))
    _close(to, np.asarray(jo).reshape(B, S, H, Dv))


def test_flash_without_grad_saves_nothing_and_refuses_offsets():
    """Under no_grad (every serving path) the forward records no graph;
    q_offset and kv_len still raise."""
    q, k, v, _ = _inputs(1, 40, 2, 2, 16, 16)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.no_grad():
        out = TF.flash_attention(tq, tk, tv)
    assert out.grad_fn is None and not out.requires_grad
    assert TF.flash_attention(tq, tk, tv).grad_fn is not None
    with pytest.raises(NotImplementedError):
        TF.flash_attention(tq, tk, tv, q_offset=3)
    with pytest.raises(NotImplementedError):
        TF.flash_attention(tq, tk, tv, kv_len=torch.tensor([5]))
