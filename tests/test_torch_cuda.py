"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: each test skips without a CUDA device.  The file
imports no JAX, so with ``--noconftest`` (tests/conftest.py imports JAX)
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from torch_inputs import attention_inputs, paged_inputs  # noqa: E402


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (8, 4, 48), (3, 1, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain_version(H, Hkv, D, dtype):
    _need_cuda()
    dt = getattr(torch, dtype)
    q, kp, vp, bt, lens = paged_inputs(8, H, Hkv, D, max_bt=20, seed=D)
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp, bt, lens)]
    args[:3] = [a.to(dt) for a in args[:3]]
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*args)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(1, 49152), (8, 49152), (8, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_gate_kernel_matches_plain_version(B, V, dtype):
    _need_cuda()
    rng = np.random.default_rng(V + B)
    x = rng.standard_normal((B, V)).astype(np.float32) * 3.0
    top = float(x.max()) + 1.0
    x[0, 2047 % V] = x[0, 2048 % V] = top      # tie: first index wins
    x = torch.from_numpy(x).cuda().to(getattr(torch, dtype))
    g, w = ops.confidence_gate(x), ref.confidence_gate_ref(x)
    assert torch.equal(g["argmax"], w["argmax"])
    assert int(g["argmax"][0]) == min(2047 % V, 2048 % V)
    for k in ("max_prob", "entropy", "margin"):
        torch.testing.assert_close(g[k], w[k], atol=1e-5, rtol=4e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                                         (1, 1024, 15, 5, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_kernel_matches_plain_version(B, S, H, Hkv, D, dtype,
                                                      causal, window):
    _need_cuda()
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).cuda().to(dt)
               for a in attention_inputs(B, S, H, Hkv, D, seed=S))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (8, 4, 48), (3, 1, 80)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel_matches_plain_version(H, Hkv, D, dtype):
    """Ragged lengths over a 2048-position cache, with 1e4 planted past
    every length: a read past kv_len would show."""
    _need_cuda()
    dt = getattr(torch, dtype)
    lens = torch.tensor([1, 2048, 37, 1000, 511, 16, 1999, 260],
                        dtype=torch.int32)
    _, k, v = attention_inputs(8, 2048, H, Hkv, D, seed=D)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    past = torch.arange(2048)[None, :] >= lens[:, None]
    k[past], v[past] = 1e4, 1e4
    q = torch.randn((8, H, D), generator=torch.Generator().manual_seed(D))
    q, k, v = (t.cuda().to(dt) for t in (q, k, v))
    ops.reset_launches()
    got = ops.decode_attention(q, k, v, lens.cuda())
    want = ref.decode_attention_ref(q, k, v, lens.cuda())
    assert ops.launch_counts()["decode_attention"] == 1
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
