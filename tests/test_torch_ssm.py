"""The port's Mamba2 SSD scan and Mamba2 block against the JAX package's.

Scan: the port's plain version ``kernels.ref.ssm_chunk_scan_ref`` (what
``ops.ssm_chunk_scan`` runs on a CPU tensor, and what the CUDA kernel is
held against on the card) against three references on the same numpy
inputs: the JAX ``models/ssm.py::ssd_chunked``, the step-by-step
recurrence (``ssm_sequential_ref`` on both sides), and the Pallas kernel
``repro.kernels.ops.ssm_chunk_scan`` in interpret mode.  Block: the
port's ``mamba2_fwd`` (prefill, with its returned state) and
``mamba2_decode`` against the JAX functions on reduced zamba2 with the
same weights, bridged.

Tolerance: atol 1e-4 plus rtol 1e-4.  Everything runs in fp32 on both
sides, but the cumsum, the einsums and the chunk scan sum in another
order in XLA and in PyTorch (|y| reaches ~50 at these shapes, and the
differences seen are below 1e-4)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy, tree_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from torch_inputs import ssm_inputs  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
# (B, S, H, P, N, chunk, strong decay)
SCAN_CASES = [(2, 128, 3, 32, 16, 64, False),     # two chunks
              (2, 64, 3, 32, 16, 64, False),      # S == chunk
              (2, 40, 3, 32, 16, 64, False),      # S < chunk: Lc = S
              (2, 128, 3, 32, 16, 64, True)]      # unmasked exp overflows


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,P,N,chunk,strong", SCAN_CASES)
def test_ssm_chunk_scan_ref_matches_jax(B, S, H, P, N, chunk, strong):
    x, dt, A, Bm, Cm = ssm_inputs(B, S, H, P, N, H, seed=S, strong=strong)
    y, h = ref.ssm_chunk_scan_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                  chunk)
    assert y.dtype == h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want = JS.ssd_chunked(*_jax(x, dt, A, Bm, Cm), chunk)
    seq = jref.ssm_sequential_ref(*_jax(x, dt, A, Bm, Cm))
    pallas = jops.ssm_chunk_scan(*_jax(x, dt, A, Bm, Cm), chunk=chunk)
    for other in (want, seq, pallas):
        _close(y, other[0])
        _close(h, other[1])


def test_ssm_sequential_ref_matches_jax():
    x, dt, A, Bm, Cm = ssm_inputs(2, 24, 3, 16, 16, 3, seed=4)
    got = ref.ssm_sequential_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    want = jref.ssm_sequential_ref(*_jax(x, dt, A, Bm, Cm))
    for g, w in zip(got, want):
        _close(g, w)


def test_ssm_chunk_scan_groups_and_initial_state():
    """Group-level B/C (G < H, head h reads group h // (H / G)) equal the
    reference's repeated tensors; an initial state h0 carries in as in
    ``ssd_chunked(h0=...)``; the CPU dispatch counts no launch."""
    x, dt, A, Bm, Cm = ssm_inputs(2, 96, 4, 16, 16, 2, seed=7)
    h0 = np.random.default_rng(8).standard_normal((2, 4, 16, 16)) \
        .astype(np.float32)
    Bh, Ch = np.repeat(Bm, 2, axis=2), np.repeat(Cm, 2, axis=2)
    ops.reset_launches()
    got = ops.ssm_chunk_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                             chunk=32, h0=torch.from_numpy(h0))
    assert ops.launch_counts()["ssm_chunk_scan"] == 0
    want = JS.ssd_chunked(*_jax(x, dt, A, Bh, Ch), 32, h0=jnp.asarray(h0))
    for g, w in zip(got, want):
        _close(g, w)


def test_ragged_length_raises_in_both():
    """S = 100 at chunk 64 is not a multiple of the chunk: the reference
    asserts, the port raises ValueError."""
    x, dt, A, Bm, Cm = ssm_inputs(1, 100, 2, 16, 16, 2, seed=1)
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*_jax(x, dt, A, Bm, Cm), 64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssm_chunk_scan_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), 64)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    """Reduced zamba2 in fp32, with n_layers=3 (one unit of 2 plus a tail
    of 1); the JAX params and the same weights bridged into the port."""
    kw = dict(param_dtype="float32", activation_dtype="float32", n_layers=3)
    jcfg, tcfg = j_reduced("zamba2-7b").with_(**kw), \
        t_reduced("zamba2-7b").with_(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg, max_seq=64)
    tparams = params_from_numpy(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("S", [40, 128])
def test_mamba2_fwd_matches_jax(block, S):
    jcfg, tcfg, jparams, tparams = block
    jp = jax.tree.map(lambda a: a[0, 1], jparams["mamba_units"])
    tp = {k: (v[0, 1] if not isinstance(v, dict)
              else {kk: vv[0, 1] for kk, vv in v.items()})
          for k, v in tparams["mamba_units"].items()}
    x = np.random.default_rng(S).standard_normal((2, S, tcfg.d_model)) \
        .astype(np.float32)
    want, wst = JS.mamba2_fwd(jp, jcfg, jnp.asarray(x), return_state=True)
    got, gst = TS.mamba2_fwd(tp, tcfg, torch.from_numpy(x), return_state=True)
    _close(got, want)
    _close(gst["ssm"], wst["ssm"])
    _close(gst["conv"], wst["conv"])


def test_mamba2_decode_matches_jax(block):
    jcfg, tcfg, jparams, tparams = block
    jp = jax.tree.map(lambda a: a[0], jparams["mamba_tail"])
    tp = {k: (v[0] if not isinstance(v, dict)
              else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["mamba_tail"].items()}
    rng = np.random.default_rng(5)
    d_inner, nh = TS._dims(tcfg)
    s = tcfg.ssm
    cache = {"ssm": rng.standard_normal((3, nh, s.head_dim, s.d_state))
             .astype(np.float32),
             "conv": rng.standard_normal(
                 (3, s.d_conv - 1, d_inner + 2 * s.n_groups * s.d_state))
             .astype(np.float32)}
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    want, wc = JS.mamba2_decode(jp, jcfg, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, cache))
    got, gc = TS.mamba2_decode(tp, tcfg, torch.from_numpy(x),
                               tree_from_numpy(cache, device="cpu"))
    _close(got, want)
    _close(gc["ssm"], wc["ssm"])
    _close(gc["conv"], wc["conv"])
