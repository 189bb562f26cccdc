"""The port's kernel dispatch (``repro_torch.kernels.ops``) against the
JAX package's Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) and their jnp oracles, on the same
numpy inputs.  On the CPU the port runs its plain PyTorch versions; the
CUDA kernels are held against those on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Attention tolerances: atol 1e-5 / rtol 1e-4 in fp32.  Both sides compute
the same fp32 softmax, but sums run in another order (blocked online
softmax in the JAX kernels, one einsum here)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from torch_inputs import (INT8_SHAPES, SHARED_HEADS,  # noqa: E402
                          SHARED_LENS, SHARED_RUN, attention_inputs,
                          int8_inputs, paged_inputs, shared_paged_inputs)

ATT_TOL = dict(atol=1e-5, rtol=1e-4)
# (H, Hkv, D) of the reduced smollm-360m and of tiansuan ONBOARD
HEADS = [(3, 1, 80), (4, 2, 48)]


# (H, Hkv, D) beside the configs' groups (2, 3): groups of 16 and of 48
# (granite's 48 query heads over one KV head), which the CUDA kernels take
GROUPS = [(16, 1, 64), (48, 1, 64)]


@pytest.mark.parametrize("H,Hkv,D", [(8, 4, 48), (3, 1, 80), (15, 5, 64)]
                         + GROUPS)
def test_paged_decode_attention_matches_jax(H, Hkv, D):
    q, kp, vp, bt, lens = paged_inputs(5, H, Hkv, D, max_bt=4, seed=D)
    got = ops.paged_decode_attention(*(torch.from_numpy(a)
                                       for a in (q, kp, vp, bt, lens)))
    assert got.shape == (5, H, D) and got.dtype == torch.float32
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, bt, lens))
    want_kernel = np.asarray(jops.paged_decode_attention(*jargs))
    want_ref = np.asarray(jref.paged_decode_attention_ref(*jargs))
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("H,Hkv,D", SHARED_HEADS)
def test_paged_decode_attention_on_shared_tables_matches_jax(H, Hkv, D):
    """Block tables after prefix-cache hits (rows naming the same
    physical pages, one forked page) through the port's CPU path and the
    JAX kernel in interpret mode."""
    args = shared_paged_inputs(SHARED_LENS, H, Hkv, D, 16, SHARED_RUN,
                               seed=H)
    bt = args[3]
    assert (bt[:, 0] == bt[0, 0]).all() and bt[1, SHARED_RUN - 1] != \
        bt[0, SHARED_RUN - 1]
    got = ops.paged_decode_attention(*(torch.from_numpy(a) for a in args))
    jargs = tuple(jnp.asarray(a) for a in args)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.paged_decode_attention(*jargs)),
        atol=2e-5, rtol=0)
    assert np.abs(got.numpy()).max() < 100.0      # no planted 1e4 read


def test_paged_decode_attention_bf16_matches_jax_ref():
    q, kp, vp, bt, lens = paged_inputs(4, 15, 5, 64, max_bt=3, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = ops.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                     torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    want = jref.paged_decode_attention_ref(jq, jk, jv, jnp.asarray(bt),
                                           jnp.asarray(lens))
    # same bf16 inputs, fp32 math on both sides: the outputs differ by at
    # most one bf16 rounding of the result
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def _block_v(V):
    """The JAX kernel's vocab block for these tests: 2048 (its default)
    at V=49152, 256 at V=512 so that the row also spans two blocks."""
    return min(2048, V // 2)


def _gate_logits(B, V, seed):
    """Scaled normal logits with a planted tie for the maximum across a
    vocab-block edge of the JAX kernel (the first index must win)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    top = float(x.max()) + 1.0
    e = _block_v(V)
    x[0, e - 1] = x[0, e] = top        # straddles the first block edge
    x[-1, V - 1] = top                 # and a tie at both ends of a row
    x[-1, 0] = top
    return x


@pytest.mark.parametrize("B,V", [(3, 512), (2, 49152)])
def test_confidence_gate_matches_jax(B, V):
    x = _gate_logits(B, V, seed=V)
    got = ops.confidence_gate(torch.from_numpy(x))
    want_kernel = jops.confidence_gate(jnp.asarray(x), block_v=_block_v(V))
    want_ref = jref.confidence_gate_ref(jnp.asarray(x))
    assert got["argmax"].dtype == torch.int32
    np.testing.assert_array_equal(got["argmax"].numpy()[[0, -1]],
                                  [_block_v(V) - 1, 0])
    # max_prob and margin lie in [0, 1]: atol 1e-5.  The entropy of a
    # 49152-way row is ~5-11 nats, summed in fp32 in another order on
    # each side (and streamed in blocks by the JAX kernel): it is held
    # to atol 1e-5 plus 32 fp32 ulps of its size (rtol 4e-6).
    for want in (want_kernel, want_ref):
        np.testing.assert_array_equal(got["argmax"].numpy(),
                                      np.asarray(want["argmax"]))
        for k in ("max_prob", "entropy", "margin"):
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                rtol=4e-6 if k == "entropy" else 0, err_msg=k)


# the EO tiers' 8 classes at a pass of 8 and of 40 tiles, the narrowest
# rows the gate takes (V = 2, 3), and a 151936-wide vocab (the widest the
# reference's gate is sized for): (B, V, the JAX kernel's vocab block)
GATE_EDGE_SHAPES = [(8, 8, 128), (40, 8, 128), (4, 2, 128), (5, 3, 128),
                    (1, 151936, 2048)]


def _gate_edge_logits(B, V, seed):
    """Scaled normal logits with planted ties for the maximum, the first
    index of each to win: in a single row, at the JAX kernel's first
    vocab-block edge (2047, 2048), at the edge between ranks 0 and 1 of
    the CUDA kernel's 16-CTA cluster (9495, 9496) and at the row's end;
    else across the CUDA kernel's two-lane group edge in row 0 (3, 4;
    (0, 1) when V < 5) and at both ends of the last row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    top = float(x.max()) + 1.0
    if B == 1:
        x[0, [2047, 2048, 9495, 9496, V - 1]] = top
        return x, {0: 2047}
    i = 3 if V >= 5 else 0
    x[0, i] = x[0, i + 1] = top
    x[-1, 0] = x[-1, V - 1] = top
    return x, {0: i, B - 1: 0}


def _entropy_f64(x):
    x = x.astype(np.float64)
    p = np.exp(x - x.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return -(p * np.log(np.maximum(p, 1e-300))).sum(axis=-1)


# The port's plain gate on the CPU takes torch's fp32 softmax, whose
# probabilities at V = 151936 are up to 1.6e-5 (relative) off a float64
# run (its sum of exps); its entropy there is 1.2e-5 off (5.9e-5 nats at
# 5.0), while the JAX kernel's and oracle's are within 1e-7.  So at that
# width the port's entropy is held to float64 at this rtol; the JAX
# references are held to float64 at the usual 4e-6.  (On the card the
# CUDA kernel is held to the plain version run there, at 4e-6.)
WIDE_ENTROPY_RTOL = 2e-5


@pytest.mark.parametrize("B,V,block_v", GATE_EDGE_SHAPES)
def test_confidence_gate_matches_jax_at_the_eo_and_edge_shapes(B, V,
                                                                block_v):
    """The port's gate against the JAX kernel in interpret mode and the
    JAX oracle, with the tolerances of test_confidence_gate_matches_jax
    (the entropy at V = 151936: each side against float64, see
    WIDE_ENTROPY_RTOL), and the first index of every planted tie."""
    x, ties = _gate_edge_logits(B, V, seed=B + V)
    got = ops.confidence_gate(torch.from_numpy(x))
    want_kernel = jops.confidence_gate(jnp.asarray(x), block_v=block_v)
    want_ref = jref.confidence_gate_ref(jnp.asarray(x))
    assert got["argmax"].dtype == torch.int32
    assert {r: int(got["argmax"][r]) for r in ties} == ties
    wide = V > 100_000
    for want in (want_kernel, want_ref):
        np.testing.assert_array_equal(got["argmax"].numpy(),
                                      np.asarray(want["argmax"]))
        for k in ("max_prob", "entropy", "margin"):
            if k == "entropy" and wide:
                np.testing.assert_allclose(np.asarray(want[k]),
                                           _entropy_f64(x), atol=1e-5,
                                           rtol=4e-6)
                continue
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                rtol=4e-6 if k == "entropy" else 0, err_msg=k)
    if wide:
        np.testing.assert_allclose(got["entropy"].numpy(), _entropy_f64(x),
                                   atol=1e-5, rtol=WIDE_ENTROPY_RTOL)


@pytest.mark.parametrize("S", [37, 128, 200])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 16), (False, 16)])
def test_flash_attention_matches_jax(S, causal, window):
    H, Hkv, D = HEADS[S % 2]
    q, k, v = attention_inputs(2, S, H, Hkv, D, seed=S + window)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.shape == (2, S, H, D) and got.dtype == torch.float32
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    want_kernel = jops.flash_attention(*jargs, causal=causal, window=window)
    want_ref = jref.flash_attention_ref(*jargs, causal=causal, window=window)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


# (Sq, Skv, causal, window): queries shorter than the keys (whisper's
# cross-attention, text against encoder frames) and longer, each ragged
# against the kernels' tiles; windows only at Sq < Skv (at Sq > Skv a
# window leaves rows with no key, which the CUDA wrapper refuses)
SQ_SKV = [(Sq, Skv, c, w) for Sq, Skv in [(37, 128), (128, 37), (64, 200)]
          for c, w in [(True, 0), (False, 0), (True, 16), (False, 16)]
          if not (w and Sq > Skv)]


@pytest.mark.parametrize("Sq,Skv,causal,window", SQ_SKV)
def test_flash_attention_at_sq_ne_skv_matches_jax(Sq, Skv, causal, window):
    """The plain flash at a query length other than the key length (the
    causal mask top-left aligned, query i seeing keys 0..i) against the
    Pallas kernel in interpret mode, its jnp oracle and the reference's
    ``models/flash.py::flash_attention`` (what whisper's cross-attention
    runs)."""
    from repro.models import flash as jflash
    H, Hkv, D = HEADS[Sq % 2]
    rng = np.random.default_rng(Sq * Skv + window)
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, Skv, Hkv, D)).astype(np.float32)
            for _ in range(2))
    got, lse = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, window=window,
                                   return_lse=True)
    assert got.shape == (2, Sq, H, D) and lse.shape == (2, H, Sq)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    for want in (jops.flash_attention(*jargs, causal=causal, window=window),
                 jref.flash_attention_ref(*jargs, causal=causal,
                                          window=window),
                 jflash.flash_attention(*jargs, causal=causal,
                                        window=window)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("H,Hkv,D", HEADS + GROUPS)
@pytest.mark.parametrize("per_seq", [False, True])
def test_decode_attention_matches_jax(H, Hkv, D, per_seq):
    """An unaligned cache of 45 positions against the JAX kernel's
    16-position blocks; scalar kv_len, or one length per sequence."""
    B, S = 3, 45
    q, k, v = attention_inputs(B, S, H, Hkv, D, seed=D)
    q = q[:, 0]
    kv_len = np.asarray([1, 29, 45], np.int32) if per_seq else np.int32(30)
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(np.asarray(kv_len)))
    assert got.shape == (B, H, D)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, kv_len))
    want_kernel = jops.decode_attention(*jargs, block_k=16)
    want_ref = jref.decode_attention_ref(*jargs)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("N,D", INT8_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_matches_jax(N, D, dtype):
    """The port's plain int8 quantization against the JAX oracle and the
    JAX kernel in interpret mode.  Against the oracle q is exactly equal
    (both divide by the scale and round half to even) and so is the
    scale.  The interpret-mode kernel's scale is the oracle's within
    rtol 1e-6 but not bit for bit: XLA folds its ``/ 127.0`` into a
    multiply by 1/127, one ulp off the division.  So its q is held
    exactly equal wherever x / scale does not sit within 1e-6 of a .5
    tie, and within one step there (a one-ulp scale moves such a value
    across the tie; bf16 rows with a bf16-exact absmax put values there,
    and the reference's own kernel test allows a step of 1)."""
    x = int8_inputs(N, D, seed=N + D)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    xf = np.asarray(jx.astype(jnp.float32))
    tx = torch.from_numpy(xf).to(getattr(torch, dtype))
    q, s = ops.int8_quantize(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (N, D) and s.shape == (N,)
    oq, os_ = jref.int8_quantize_ref(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(oq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(os_))
    kq, ks = jops.int8_quantize(jx, block_rows=128)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), rtol=1e-6, atol=0)
    ratio = xf / s.numpy()[:, None]
    near_tie = np.abs(np.abs(ratio - np.floor(ratio)) - 0.5) \
        <= 1e-6 * np.maximum(np.abs(ratio), 1.0)
    diff = q.numpy().astype(np.int32) - np.asarray(kq).astype(np.int32)
    assert not diff[~near_tie].any()
    assert np.abs(diff).max() <= 1
    # a zero row, and the planted ties rounded half to even
    assert not q[1].any() and float(s[1]) == np.float32(1e-8) / 127
    np.testing.assert_array_equal(q[2, :9].numpy(),
                                  [127, 0, 2, 2, 0, -2, -2, 126, -126])
    np.testing.assert_array_equal(q[3, :9].numpy(), q[2, :9].numpy())
    # dequantization error at most half a step, plus the fp32 rounding
    # of q * scale and of the difference (at most an ulp of |x|)
    xt = tx.float()
    err = (ref.int8_dequantize_ref(q, s) - xt).abs()
    eps = torch.finfo(torch.float32).eps
    assert bool((err <= s[:, None] / 2 + eps * xt.abs()).all())


def _conv_views():
    """x and B cut from one (B, S, H*P + 2*G*N) bf16 tensor as mamba2_fwd
    cuts them at zamba2's widths (sequence stride 7296)."""
    xbc = torch.zeros((1, 4, 112 * 64 + 2 * 64), dtype=torch.bfloat16)
    x, Bm, _ = torch.split(xbc, [112 * 64, 64, 64], dim=-1)
    return x.reshape(1, 4, 112, 64), Bm.reshape(1, 4, 1, 64)


@pytest.mark.parametrize("case,aligned", [
    ("contiguous", True), ("conv_views", True), ("shifted", False),
    ("odd_row_stride", False)])
def test_rows_aligned_decides_what_the_bf16_tiles_take(case, aligned):
    """The bf16 tensor-core kernels copy rows in 16-byte pieces, so their
    wrappers take a tensor only where every row of the last axis starts
    on a 16-byte boundary (the check needs no card)."""
    from repro_torch.kernels.build import rows_aligned
    bf = torch.bfloat16
    if case == "contiguous":
        ts = [torch.zeros((2, 3, 4, 64), dtype=bf)]
    elif case == "conv_views":
        ts = list(_conv_views())
    elif case == "shifted":
        ts = [torch.zeros(2 * 64 + 1, dtype=bf)[1:].view(2, 64)]
    else:
        ts = [torch.zeros((2, 5, 68), dtype=bf)[:, :, :64]]
    assert all(rows_aligned(t) == aligned for t in ts)
