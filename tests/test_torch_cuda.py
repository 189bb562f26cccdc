"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: each test skips without a CUDA device.  The file
imports no JAX, so with ``--noconftest`` (tests/conftest.py imports JAX)
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import conf_gate as KG  # noqa: E402
from repro_torch.kernels import decode_attention as KD  # noqa: E402
from repro_torch.kernels import int8_quant as KQ  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as KP  # noqa: E402
from torch_inputs import (EDGE_HEADS, EDGE_PAGE_SIZES,  # noqa: E402
                          INT8_ODD, INT8_SHAPES, SHARED_CASES, SHARED_HEADS,
                          SINGLE_LENS, SINGLE_PAGES, attention_inputs,
                          edge_lengths,
                          int8_inputs, paged_inputs, paged_lengths_inputs,
                          shared_paged_inputs, ssm_inputs)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (8, 4, 48), (3, 1, 80),
                                     (16, 1, 128), (48, 1, 128),
                                     (32, 4, 128),
                                     # one rank's heads of a 4-rank mesh:
                                     # qwen1.5-4b's 20/20, qwen3-moe's 32/4
                                     (5, 5, 128), (8, 1, 128)])
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
@pytest.mark.parametrize("B,V", [(1, 49152), (8, 49152), (8, 512), (4096, 8),
                                 (37, 8), (1, 151936), (1, 129280)])
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


# The gate's three layouts (kernels/csrc/conf_gate.cu) across their
# edges: narrow rows (a lane group a row up to 512 bytes, or up to 2 KB at
# B = 4096; the group width changes at each power of two of 16-byte
# vectors), one CTA a row (B = 37 at 1 KB, B = 4096 beyond 2 KB) and a
# cluster a row (too few rows to fill the card: C = 2 at B = 37, 16 at
# B <= 8).  An odd V puts rows off 16 bytes.
GATE_EDGE_CASES = ([(B, V) for V in (2, 3, 5, 8, 9, 31, 33, 128, 129, 257)
                    for B in (1, 37)]
                   + [(4096, 8), (4096, 9), (4096, 257)]
                   + [(B, V) for V in (4097, 49152) for B in (1, 3, 37, 4096)]
                   + [(B, 151936) for B in (1, 3, 37)])


def _gate_matches_plain(x, first=None):
    """One launch on x against the plain version: argmax exact (and
    ``first`` where given), max_prob and margin within 1e-5, entropy
    within 1e-5 + 4e-6 * |entropy| (chip_smoke.py's GATE_ATOL and
    ENTROPY_RTOL)."""
    ops.reset_launches()
    g = ops.confidence_gate(x)
    w = ref.confidence_gate_ref(x)
    assert ops.launch_counts()["confidence_gate"] == 1
    assert torch.equal(g["argmax"], w["argmax"])
    if first is not None:
        assert bool((g["argmax"] == first).all()), g["argmax"][:8]
    for k in ("max_prob", "entropy", "margin"):
        torch.testing.assert_close(g[k], w[k], atol=1e-5,
                                   rtol=4e-6 if k == "entropy" else 0)


def _gate_tie_pairs(B, V, dtype):
    """Index pairs where a tie for the maximum crosses an edge of the cut
    the kernel takes at (B, V): both row ends, the first two lanes' (or
    threads') first 16-byte vectors, and a cluster rank's slice."""
    p = KG.plan(B, V, dtype)
    W = 16 // torch.empty((), dtype=dtype).element_size()
    pairs = [(0, V - 1)]
    if V > W:
        pairs.append((W - 1, W))
    if p["layout"] == "cluster":
        pairs.append((p["slice"] - 1, p["slice"]))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", GATE_EDGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_confidence_gate_at_its_layout_edges(B, V, dtype):
    """Every row ties for its maximum across one edge of the cut (the
    first index must win): on the tensor, at a pointer one element past a
    16-byte boundary, and one column narrower (x[:, 1:], against the
    plain version)."""
    _need_cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(V + B)
    base = (torch.randn((B, V), generator=gen, device="cuda") * 3.0).to(dt)
    top = float(base.float().max()) + 1.0
    for i, j in _gate_tie_pairs(B, V, dt):
        x = base.clone()
        x[:, i] = x[:, j] = top
        shifted = torch.empty(B * V + 1, dtype=dt, device="cuda")[1:]
        shifted = shifted.view(B, V).copy_(x)
        assert shifted.data_ptr() % 16
        _gate_matches_plain(x, first=i)
        _gate_matches_plain(shifted, first=i)
        if V > 2:
            _gate_matches_plain(x[:, 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(37, 8), (605, 9), (1, 257), (3, 4097),
                                 (4096, 4097), (1, 49152), (1, 151936)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_gate_all_equal_rows(B, V, dtype):
    """A row of equal values: argmax 0, margin exactly 0 (max2 counts
    multiplicity), max_prob 1 / V and entropy log V."""
    _need_cuda()
    x = torch.full((B, V), 0.75, dtype=getattr(torch, dtype), device="cuda")
    g = ops.confidence_gate(x)
    assert bool((g["argmax"] == 0).all())
    assert bool((g["margin"] == 0).all())
    torch.testing.assert_close(g["max_prob"], torch.full_like(
        g["max_prob"], 1.0 / V), atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(g["entropy"], torch.full_like(
        g["entropy"], float(np.log(V))), atol=1e-5, rtol=4e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V", [(605, 8), (8, 512), (4096, 4097),
                                 (37, 4097), (1, 49152), (1, 151936)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_confidence_gate_repeats_its_bits(B, V, dtype):
    """The merge order is fixed by the layout (lanes, warps, cluster
    ranks) and nothing uses atomics: 20 launches give the first's
    bits."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = (torch.randn((B, V), generator=gen, device="cuda") * 3.0) \
        .to(getattr(torch, dtype))
    first = ops.confidence_gate(x)
    for _ in range(20):
        again = ops.confidence_gate(x)
        assert all(torch.equal(again[k], first[k]) for k in first)


@pytest.mark.cuda
def test_confidence_gate_plan_follows_the_width():
    """The cut the design note describes, at the paths' shapes: the EO
    tiers' 8 classes in lane groups of 2 (fp32) or 1 (bf16) lanes, 128 or
    256 rows a CTA; 2 KB rows in lane groups of 32 only when there are
    more rows than two an SM; one 49152- or 151936-wide row over a 16-CTA
    cluster; enough wide rows for the card one CTA each."""
    _need_cuda()
    f32, bf16 = torch.float32, torch.bfloat16
    assert KG.plan(4096, 8, f32) == dict(layout="narrow", G=2, C=1,
                                         threads=256, ctas=32, slice=8, K=1)
    assert KG.plan(605, 8, bf16)["G"] == 1
    assert KG.plan(605, 8, bf16)["ctas"] == 3
    p = KG.plan(4096, 512, f32)
    assert (p["layout"], p["G"], p["K"]) == ("narrow", 32, 4)
    assert KG.plan(8, 512, f32)["layout"] == "rows"
    assert KG.plan(8, 128, f32)["layout"] == "narrow"
    for V in (49152, 151936):
        for dt in (f32, bf16):
            p = KG.plan(1, V, dt)
            assert p["layout"] == "cluster" and p["C"] == 16, p
            assert 16 * p["slice"] >= V > 15 * p["slice"], p
    assert KG.plan(8, 49152, f32)["ctas"] == 128
    assert KG.plan(37, 4097, f32)["C"] == 2
    assert KG.plan(4096, 49152, f32)["layout"] == "rows"


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [(2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                                         (1, 1024, 15, 5, 64),
                                         (1, 512, 32, 32, 112),
                                         (2, 130, 6, 2, 16),
                                         (2, 150, 4, 1, 32),
                                         (2, 120, 8, 4, 96),
                                         (2, 200, 4, 2, 128),
                                         (2, 200, 48, 1, 128),
                                         (2, 150, 12, 1, 64),
                                         (1, 70, 22, 2, 32)])
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


# (B, S, H, Hkv, D, Dv): flash where chip_smoke.py's training phases
# launch it: smollm-360m's training step (8 x 256), the tiansuan pair's
# ONBOARD (4/2 heads) and GROUND (8/4) at D = 48 in training (8 x 96) and
# in the cascade's 95-token forwards; then an odd group and length, and
# deepseek-v3's MLA prefill at q/k 192, v 128; granite's 48 query heads
# over one KV head (six slices of 8 heads) and a group of 12 (slices of 6);
# whisper-tiny's decoder self-attention in training (8 x 128, 6/6 heads
# of 64) and qwen2-vl-2b's (8 x (256 patches + 128 text), 12/2 of 128)
FLASH_GRAD_SHAPES = [(2, 130, 48, 1, 128, 128), (2, 97, 24, 2, 64, 64), (8, 256, 15, 5, 64, 64), (8, 96, 4, 2, 48, 48),
                     (8, 96, 8, 4, 48, 48), (8, 95, 4, 2, 48, 48),
                     (8, 95, 8, 4, 48, 48), (2, 333, 3, 1, 80, 80),
                     (2, 1024, 128, 128, 192, 128), (8, 128, 6, 6, 64, 64),
                     (8, 384, 12, 2, 128, 128)]


def _flash_grad_inputs(B, S, H, Hkv, D, Dv, dt, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda().to(dt) for s in ((B, S, H, D), (B, S, Hkv, D),
                                     (B, S, Hkv, Dv), (B, S, H, Dv))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_lse_matches_plain_version(shape, dtype, causal, window):
    """The kernel's log-sum-exp output (B, H, S) against the plain
    version's, in both types within atol, rtol 1e-5 (fp32 on both sides,
    from the same operands; chip_smoke.py's LSE_TOL); out is the same
    bits with and without it."""
    _need_cuda()
    q, k, v, _ = _flash_grad_inputs(*shape, getattr(torch, dtype), seed=7)
    kw = dict(causal=causal, window=window)
    ops.reset_launches()
    out, lse = ops.flash_attention(q, k, v, **kw, return_lse=True)
    assert ops.launch_counts()["flash_attention"] == 1
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    want = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)[1]
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64)])
def test_flash_autograd_matches_plain_version(shape, dtype, causal, window):
    """dq, dk, dv of ``models.flash`` (the kernel's forward with its lse,
    the plain flash backward) against autograd through the plain version
    on fp32 copies of the inputs, as chip_smoke.py's
    ``_flash_grad_share`` holds them: fp32 within atol 1e-5 + rtol 1e-4;
    bf16 within twice the error of the same flash backward on the plain
    forward's bf16 out and lse, plus atol 1e-3 (the reference's backward
    takes delta from the out it returns in bf16, so its bf16 gradients
    carry that rounding)."""
    _need_cuda()
    from repro_torch.models.flash import flash_attention, flash_bwd
    dt = getattr(torch, dtype)
    q, k, v, do = _flash_grad_inputs(*shape, dt, seed=11)
    kw = dict(causal=causal, window=window)
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    got = torch.autograd.grad(flash_attention(*xs, **kw), xs, do)
    assert ops.launch_counts()["flash_attention"] == 1
    xf = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*xf, **kw), xf,
                               do.float())
    for g in got:
        assert g.dtype == dt
    if dtype == "float32":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
        return
    with torch.no_grad():
        out, lse = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)
        plain = flash_bwd(q, k, v, out, lse, do, **kw)
    for g, p, w in zip(got, plain, want):
        bound = 2.0 * float((p.float() - w).abs().max()) + 1e-3
        assert float((g.float() - w).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(2, 1024, 128), (2, 200, 8), (2, 17, 4),
                                   (1, 65, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_at_mla_head_dims(B, S, H, dtype, causal, window):
    """DeepSeek-V3's expanded MLA prefill: q/k head dim 192, v head dim
    128 (the output's), scale 192 ** -0.5, 128/128 heads at the serving
    length, and short and ragged lengths."""
    _need_cuda()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + H)
    q, k = (torch.from_numpy(rng.standard_normal((B, S, H, 192))
                             .astype(np.float32)).cuda().to(dt)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, S, H, 128))
                         .astype(np.float32)).cuda().to(dt)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.shape == (B, S, H, 128)
    assert ops.launch_counts()["flash_attention"] == 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (B, Sq, Skv, H, Hkv, D): whisper-tiny's cross-attention (64 text
# positions against 1500 frames, 6/6 heads of 64) and its encoder length
# against a short decoder, then causal pairs each way at an odd group,
# and lengths shorter than one 64-key tile against a longer key run;
# whisper-tiny's cross-attention in training (8 x 128 against 1500)
SQ_SKV_SHAPES = [(2, 64, 1500, 6, 6, 64), (1, 1500, 64, 6, 6, 64),
                 (2, 200, 333, 4, 2, 64), (2, 333, 200, 4, 2, 64),
                 (2, 17, 130, 15, 5, 64), (2, 130, 17, 8, 8, 112),
                 (8, 128, 1500, 6, 6, 64)]


def _sq_skv_inputs(B, Sq, Skv, H, Hkv, D, dt, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .cuda().to(dt) for s in ((B, Sq, H, D), (B, Skv, Hkv, D),
                                     (B, Skv, Hkv, D), (B, Sq, H, D))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SQ_SKV_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_at_sq_ne_skv_matches_plain_version(shape, dtype,
                                                            causal):
    """The kernel at a query length other than the key length (the causal
    mask top-left aligned, as the Pallas kernel's): out at the tolerances
    of the S = Skv cases, the lse at atol, rtol 1e-5, out the same bits
    with and without the lse; and, where Sq < Skv, a window of 64."""
    _need_cuda()
    dt = getattr(torch, dtype)
    q, k, v, _ = _sq_skv_inputs(*shape, dt, seed=sum(shape))
    tol = 1e-5 if dtype == "float32" else 1e-2
    windows = (0, 64) if shape[1] < shape[2] else (0,)
    for window in windows:
        kw = dict(causal=causal, window=window)
        ops.reset_launches()
        out, lse = ops.flash_attention(q, k, v, **kw, return_lse=True)
        assert ops.launch_counts()["flash_attention"] == 1
        assert out.shape == q.shape and lse.shape == (shape[0], shape[3],
                                                      shape[1])
        want, want_lse = ref.flash_attention_ref(q, k, v, **kw,
                                                 return_lse=True)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
        assert torch.equal(out, ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SQ_SKV_SHAPES[:4] + SQ_SKV_SHAPES[-1:])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_at_sq_ne_skv_matches_plain_version(shape, dtype,
                                                          causal):
    """dq (B, Sq, ...), dk and dv (B, Skv, ...) of ``models.flash`` at
    Sq != Skv, held as test_flash_autograd_matches_plain_version holds
    them."""
    _need_cuda()
    from repro_torch.models.flash import flash_attention, flash_bwd
    dt = getattr(torch, dtype)
    q, k, v, do = _sq_skv_inputs(*shape, dt, seed=sum(shape) + 1)
    kw = dict(causal=causal, window=0)
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*xs, **kw), xs, do)
    xf = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*xf, **kw), xf,
                               do.float())
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    if dtype == "float32":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)
        return
    with torch.no_grad():
        out, lse = ref.flash_attention_ref(q, k, v, **kw, return_lse=True)
        plain = flash_bwd(q, k, v, out, lse, do, **kw)
    for g, p, w in zip(got, plain, want):
        bound = 2.0 * float((p.float() - w).abs().max()) + 1e-3
        assert float((g.float() - w).abs().max()) <= bound


@pytest.mark.cuda
def test_flash_attention_refuses_a_window_at_sq_above_skv():
    """A window at Sq > Skv would leave query rows with no key to see:
    the wrapper raises rather than write them."""
    _need_cuda()
    q = torch.zeros((1, 80, 2, 64), device="cuda")
    k = torch.zeros((1, 40, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=16)
    ops.flash_attention(k, q, q, window=16)      # Sq < Skv: taken


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_refuses_split_dims_it_has_no_tiles_for(dtype):
    """Both types take D != Dv only at (192, 128): (128, 64) and
    (192, 64) raise."""
    _need_cuda()
    dt = dict(device="cuda", dtype=getattr(torch, dtype))
    for D, Dv in ((128, 64), (192, 64)):
        q = torch.zeros((1, 8, 2, D), **dt)
        v = torch.zeros((1, 8, 2, Dv), **dt)
        with pytest.raises(ValueError, match="192, 128"):
            ops.flash_attention(q, q, v)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 65])
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (8, 8, 112)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_bf16_short_and_ragged_lengths(S, H, Hkv, D, causal,
                                                       window):
    """The tensor-core tiles against the plain version where S is shorter
    than one 64-key tile (1, 17) or one past it (65): zero-filled K/V
    rows, masked keys past S, and (at g = 3) CTAs of 21 positions."""
    _need_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in attention_inputs(2, S, H, Hkv, D, seed=S + D))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_what_the_tiles_cannot_take():
    """bf16 needs D % 16 == 0 and 16-byte aligned rows: a head size of 40
    and a view one element past an aligned start raise ValueError (no
    other path takes them)."""
    _need_cuda()
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q, k = torch.zeros((1, 8, 2, 40), **bf), torch.zeros((1, 8, 2, 40), **bf)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.flash_attention(q, k, k)
    buf = torch.zeros(1 * 8 * 2 * 64 + 1, **bf)
    shifted = buf[1:].view(1, 8, 2, 64)
    k = torch.zeros((1, 8, 2, 64), **bf)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(shifted, k, k)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(k, k, shifted)


@pytest.mark.cuda
def test_flash_and_ssm_kernels_repeat_their_bits():
    """Neither kernel uses atomics: 20 launches on one input give the
    first launch's bits (flash at g = 3 causal, the SSD scan at zamba2's
    widths over two chunks with B/C views)."""
    _need_cuda()
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16)
               for a in attention_inputs(2, 300, 15, 5, 64, seed=7))
    first = ops.flash_attention(q, k, v)
    assert all(torch.equal(ops.flash_attention(q, k, v), first)
               for _ in range(20))
    args = _ssm_views(1, 512, 16, 64, 64, 1, seed=8, strong=False,
                      views=True, dt=torch.bfloat16)
    y0, h0 = ops.ssm_chunk_scan(*args, chunk=256)
    for _ in range(20):
        y, h = ops.ssm_chunk_scan(*args, chunk=256)
        assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (8, 4, 48), (3, 1, 80),
                                     (32, 32, 112), (16, 1, 128),
                                     (48, 1, 128), (32, 4, 128)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(48, 1, 128), (15, 5, 64), (20, 20, 128),
                                     (32, 4, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_lse_matches_plain_version(H, Hkv, D, dtype):
    """The kernel with ``return_lse`` on one rank's slice of a cache cut
    on its positions (1024 of them), with lengths 0 (out 0, lse -1e30
    exactly), 1 and the whole slice among the rows: out as without the
    lse, both held to the plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    lens = torch.tensor([1024, 0, 512, 1, 1000, 37, 700, 260],
                        dtype=torch.int32)
    _, k, v = attention_inputs(8, 1024, H, Hkv, D, seed=D + 1)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    past = torch.arange(1024)[None, :] >= lens[:, None]
    k[past], v[past] = 1e4, 1e4
    q = torch.randn((8, H, D), generator=torch.Generator().manual_seed(D))
    q, k, v = (t.cuda().to(dt) for t in (q, k, v))
    ops.reset_launches()
    o, lse = ops.decode_attention(q, k, v, lens.cuda(), return_lse=True)
    assert ops.launch_counts()["decode_attention"] == 1
    want_o, want_l = ref.decode_attention_ref(q, k, v, lens.cuda(),
                                              return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (8, H)
    assert torch.all(o[1] == 0) and torch.all(lse[1] == -1e30)
    tol = _decode_tol(dtype)
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_l, atol=1e-5, rtol=1e-5)
    assert torch.equal(ops.decode_attention(q, k, v, lens.cuda()), o)


@pytest.mark.cuda
@pytest.mark.parametrize("run,lens", SHARED_CASES)
@pytest.mark.parametrize("H,Hkv,D", SHARED_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_on_shared_block_tables(run, lens, H, Hkv, D,
                                                     dtype):
    """Rows naming the same physical pages (a prefix-cache hit of 4 or 16
    pages) and one forked page: one launch, against the plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).cuda() for a in shared_paged_inputs(
        lens, H, Hkv, D, 16, run, seed=H)]
    args[:3] = [a.to(dt) for a in args[:3]]
    assert bool((args[3][:, 0] == args[3][0, 0]).all())
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    tol = _decode_tol(dtype)
    torch.testing.assert_close(
        got.float(), ref.paged_decode_attention_ref(*args).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_paged_pages_on_the_card_is_bit_exact(dtype):
    """The copy-on-write page copy on a CUDA pool gives the CPU's bits."""
    _need_cuda()
    from repro_torch.models.transformer import copy_paged_pages
    gen = torch.Generator().manual_seed(3)
    pool = {"blocks": {k: torch.randn((3, 9, 16, 5, 64), generator=gen)
                       .to(getattr(torch, dtype)) for k in ("k", "v")}}
    cuda = {"blocks": {k: t.cuda() for k, t in pool["blocks"].items()}}
    for cache in (pool, cuda):
        copy_paged_pages(cache, [2, 5, 7], [8, 1, 3])
    for k in ("k", "v"):
        got, want = cuda["blocks"][k].cpu(), pool["blocks"][k]
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert torch.equal(want[:, 8], want[:, 2])


def _decode_tol(dtype):
    return 2e-5 if dtype == "float32" else 1e-2


def _paged_args(lens, H, Hkv, D, ps, dt, seed):
    q, kp, vp, bt, kl = (torch.from_numpy(a).cuda() for a in
                         paged_lengths_inputs(lens, H, Hkv, D, ps, seed))
    return [q.to(dt), kp.to(dt), vp.to(dt), bt, kl]


def _contiguous_args(lens, S, H, Hkv, D, dt, seed):
    """A (B, S) cache with 1e4 planted past every length."""
    _, k, v = attention_inputs(len(lens), S, H, Hkv, D, seed=seed)
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    kl = torch.tensor(lens, dtype=torch.int32)
    past = torch.arange(S)[None, :] >= kl[:, None]
    k[past], v[past] = 1e4, 1e4
    q = torch.randn((len(lens), H, D),
                    generator=torch.Generator().manual_seed(seed))
    return [t.cuda().to(dt) for t in (q, k, v)] + [kl.cuda()]


def _both_match_plain(lens, H, Hkv, D, ps, dtype, seed, S=None):
    """The paged (pages of ps) and the contiguous kernel at these
    lengths, each one launch, each against its plain version."""
    dt = getattr(torch, dtype)
    tol = _decode_tol(dtype)
    args = _paged_args(lens, H, Hkv, D, ps, dt, seed)
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    torch.testing.assert_close(
        got.float(), ref.paged_decode_attention_ref(*args).float(),
        atol=tol, rtol=tol)
    args = _contiguous_args(lens, S or max(lens), H, Hkv, D, dt, seed)
    got = ops.decode_attention(*args)
    assert ops.launch_counts()["decode_attention"] == 1
    torch.testing.assert_close(
        got.float(), ref.decode_attention_ref(*args).float(), atol=tol,
        rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", EDGE_HEADS)
@pytest.mark.parametrize("ps", EDGE_PAGE_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_at_tile_and_cluster_edges(H, Hkv, D, ps, dtype):
    """Eight sequences with kv_len 1, tile - 1, tile, tile + 1 and
    C*tile - 1, C*tile, C*tile + 1 (and one more tile) for the cut the
    kernels choose at these sizes: a CTA's range ending just before,
    at and just past a tile, and the cluster's CTAs each getting one
    tile, less or more."""
    _need_cuda()
    dt = getattr(torch, dtype)
    cut = KD.plan(8, H, Hkv, D, 4096, dt)
    C, tile = cut["C"], cut["tile"]
    lens = edge_lengths(C, tile)
    paged = KP.plan(8, H, Hkv, D, ps, -(-max(lens) // ps), dt)
    assert (paged["C"], paged["tile"]) == (C, tile)
    _both_match_plain(lens, H, Hkv, D, ps, dtype, seed=D + ps)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (48, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_over_an_8192_position_cache(H, Hkv, D, dtype):
    """A cache of 8192 positions: each CTA of a cluster loops over
    several tiles with the online softmax."""
    _need_cuda()
    lens = [8192, 8191, 4097, 1, 777, 8000, 3, 6000]
    cut = KD.plan(8, H, Hkv, D, 8192, getattr(torch, dtype))
    assert 8192 > 2 * cut["C"] * cut["tile"]
    _both_match_plain(lens, H, Hkv, D, 16, dtype, seed=5, S=8192)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_bad_page_makes_only_its_sequence_nan(dtype):
    """A table entry outside the pool, inside a sequence's length, makes
    that sequence's rows NaN (every head) and is never read; the other
    sequences of the call are untouched."""
    _need_cuda()
    dt = getattr(torch, dtype)
    lens = [1000, 37, 2048, 511, 16, 1999, 260, 1]
    args = _paged_args(lens, 15, 5, 64, 16, dt, seed=11)
    bt, n_pages = args[3], args[1].shape[0]
    good = bt.clone()
    bt[2, 40] = n_pages + 7
    bt[5, 0] = -3
    got = ops.paged_decode_attention(*args)
    args[3] = good
    want = ref.paged_decode_attention_ref(*args)
    assert bool(torch.isnan(got[[2, 5]]).all())
    rest = [0, 1, 3, 4, 6, 7]
    tol = _decode_tol(dtype)
    torch.testing.assert_close(got[rest].float(), want[rest].float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", [(15, 5, 64), (48, 1, 128)])
def test_decode_kernels_repeat_their_bits(H, Hkv, D):
    """The cluster merge reads the partials in rank order and nothing
    uses atomics: 20 launches on one input give the first launch's
    bits, paged and contiguous."""
    _need_cuda()
    lens = [1, 2048, 37, 1000, 511, 16, 1999, 260]
    args = _paged_args(lens, H, Hkv, D, 16, torch.bfloat16, seed=3)
    first = ops.paged_decode_attention(*args)
    assert all(torch.equal(ops.paged_decode_attention(*args), first)
               for _ in range(20))
    args = _contiguous_args(lens, 2048, H, Hkv, D, torch.bfloat16, seed=3)
    first = ops.decode_attention(*args)
    assert all(torch.equal(ops.decode_attention(*args), first)
               for _ in range(20))


# (B, S, H, P, N, G, chunk, strong decay, views): zamba2-7b's prefills
# over two and three chunks (group-level B/C, G = 1) with x, B and C cut
# as views from one (B, S, H*P + 2*G*N) tensor as mamba2_fwd cuts them,
# zamba2's widths on contiguous tensors, the reduced config's widths, a
# prompt shorter than the chunk with P = 48, N = 128 over three chunks,
# a decay strong enough (A = -16, dt ~ 6) that an unmasked exp
# overflows, and P = 128 with N = 64 and 128 (the bf16 kernel's wide
# register tiles, which no config uses)
SSM_SHAPES = [(4, 512, 112, 64, 64, 1, 256, False, True),
              (1, 768, 112, 64, 64, 1, 256, False, True),
              (1, 512, 112, 64, 64, 1, 256, False, False),
              (2, 128, 8, 32, 16, 8, 64, False, False),
              (1, 200, 5, 48, 16, 5, 256, False, False),
              (2, 768, 8, 64, 128, 2, 256, False, False),
              (2, 256, 4, 32, 16, 4, 64, True, False),
              (1, 256, 4, 128, 64, 1, 256, False, True),
              (1, 384, 4, 128, 128, 2, 128, False, False)]


def _ssm_views(B, S, H, P, N, G, seed, strong, views, dt):
    """ssm_inputs on the card in ``dt``, with x, B and C cut as views from
    one (B, S, H*P + 2*G*N) tensor as mamba2_fwd cuts them (``views``) or
    contiguous; dt and A in fp32."""
    x, dtv, A, Bm, Cm = ssm_inputs(B, S, H, P, N, G, seed=seed,
                                   strong=strong)
    xbc = torch.from_numpy(np.concatenate(
        [x.reshape(B, S, H * P), Bm.reshape(B, S, G * N),
         Cm.reshape(B, S, G * N)], axis=-1)).cuda().to(dt)
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                 Cm.reshape(B, S, G, N))
    if not views:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    return (x, torch.from_numpy(dtv).cuda(), torch.from_numpy(A).cuda(),
            Bm, Cm)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,strong,views", SSM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_chunk_scan_kernel_matches_plain_version(B, S, H, P, N, G, chunk,
                                                     strong, views, dtype):
    """fp32 y and state from bf16 or fp32 x/B/C.  Both sides do fp32
    arithmetic on the same (rounded) inputs, in another order: atol 1e-3
    plus rtol 1e-4 of the plain value (|y| reaches ~250 here).  The
    (4, 512) view case holds y to atol 2e-3: among its 14.7M outputs one
    sits at |y| ~0.15 where terms of ~250 cancel, and there the two
    summation orders differ by 1.13e-3 (H100, both input types)."""
    _need_cuda()
    x, dtv, A, Bm, Cm = _ssm_views(B, S, H, P, N, G, seed=S + N,
                                   strong=strong, views=views,
                                   dt=getattr(torch, dtype))
    ops.reset_launches()
    y, h = ops.ssm_chunk_scan(x, dtv, A, Bm, Cm, chunk=chunk)
    want_y, want_h = ref.ssm_chunk_scan_ref(x, dtv, A, Bm, Cm, chunk)
    assert ops.launch_counts()["ssm_chunk_scan"] == 1
    assert y.dtype == h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    atol = 2e-3 if (B, S, views) == (4, 512, True) else 1e-3
    torch.testing.assert_close(y, want_y, atol=atol, rtol=1e-4)
    torch.testing.assert_close(h, want_h, atol=1e-3, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,strong,views",
                         [SSM_SHAPES[0], SSM_SHAPES[3], SSM_SHAPES[6]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_function_gradients_match_the_plain_version(B, S, H, P, N, G,
                                                        chunk, strong, views,
                                                        dtype):
    """``models.ssm.SSDChunkScan`` (the kernel's forward, one launch; the
    backward recomputed through the plain scan) against autograd through
    the plain scan on the same inputs: y as the kernel test holds it,
    and every gradient within atol 1e-5 + rtol 1e-5 of the plain one
    (the same backward on the same saved inputs: only the order of
    fp32 sums may differ), rtol one bf16 ulp (2^-7) for the bf16
    inputs' gradients, which are rounded to bf16 on both sides."""
    from repro_torch.models.ssm import SSDChunkScan
    _need_cuda()
    x, dtv, A, Bm, Cm = _ssm_views(B, S, H, P, N, G, seed=S + N,
                                   strong=strong, views=views,
                                   dt=getattr(torch, dtype))
    xs = [t.detach().requires_grad_(True) for t in (x, dtv, A, Bm, Cm)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    dh = torch.randn((B, H, P, N), generator=gen, device="cuda")
    ops.reset_launches()
    y, h = SSDChunkScan.apply(*xs, chunk)
    got = torch.autograd.grad((y, h), xs, (dy, dh))
    assert ops.launch_counts()["ssm_chunk_scan"] == 1
    wy, wh = ref.ssm_chunk_scan_ref(*xs, chunk)
    want = torch.autograd.grad((wy, wh), xs, (dy, dh))
    atol = 2e-3 if (B, S, views) == (4, 512, True) else 1e-3
    torch.testing.assert_close(y, wy.detach(), atol=atol, rtol=1e-4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(
            g.float(), w.float(), atol=1e-5,
            rtol=1e-5 if g.dtype == torch.float32 else 2.0 ** -7)



# an EO escalation payload (tiles of 32 x 32 x 3), then the shapes that
# chip_smoke.py's int8 phase shares
@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(160, 3072)] + INT8_SHAPES + INT8_ODD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_int8_quantize_kernel_matches_plain_version(N, D, dtype):
    """q bit for bit the plain version's (planted .5 ties and a zero row
    included), the scale within rtol 1e-6, dequantization error at most
    half a step (plus an ulp of |x| for the fp32 product).  Also one
    column narrower (no 16-byte rows) and at a pointer one element past
    a 16-byte boundary: the kernel's scalar path."""
    _need_cuda()
    x = torch.from_numpy(int8_inputs(N, D, seed=N + D)).cuda() \
        .to(getattr(torch, dtype))
    shifted = torch.empty(N * D + 1, dtype=x.dtype, device=x.device)[1:]
    shifted = shifted.view(N, D).copy_(x)
    for t in (x, x[:, 1:], shifted):
        ops.reset_launches()
        q, s = ops.int8_quantize(t)
        wq, ws = ref.int8_quantize_ref(t)
        assert ops.launch_counts()["int8_quantize"] == 1
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert torch.equal(q, wq)
        torch.testing.assert_close(s, ws, rtol=1e-6, atol=0)
        xf = t.float()
        err = (ref.int8_dequantize_ref(q, s) - xf).abs()
        eps = torch.finfo(torch.float32).eps
        assert bool((err <= s[:, None] / 2 + eps * xf.abs()).all())


# (N, D, dtype, path, values a slot): each side of the register plan's
# edges (a warp a row up to 64 slots, a CTA a row up to 512 x 8,
# streaming beyond), on the 16-byte path and the scalar one (an odd D),
# N not a multiple of the 8 rows a warp-row CTA takes
INT8_EDGES = [(37, 256, "float32", "warp_rows", 4),
              (37, 260, "float32", "cta_rows", 4),
              (37, 512, "bfloat16", "warp_rows", 8),
              (37, 520, "bfloat16", "cta_rows", 8),
              (5, 16384, "float32", "cta_rows", 4),
              (5, 16388, "float32", "streaming", 4),
              (5, 32768, "bfloat16", "cta_rows", 8),
              (5, 32776, "bfloat16", "streaming", 8),
              (37, 63, "float16", "warp_rows", 1),
              (37, 65, "float16", "cta_rows", 1),
              (5, 4095, "float32", "cta_rows", 1),
              (5, 4097, "float32", "streaming", 1),
              (235, 3072, "float32", "cta_rows", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,dtype,path,W", INT8_EDGES)
def test_int8_quantize_at_its_plan_edges(N, D, dtype, path, W):
    """The path the plan names at each edge, one launch, q bit for bit
    the plain version's and the scale within rtol 1e-6; at a pointer one
    element past 16 bytes the scalar path, as exact."""
    _need_cuda()
    dt = getattr(torch, dtype)
    p = KQ.plan(N, D, dt)
    assert (p["path"], p["W"]) == (path, W), p
    assert KQ.plan(N, D, dt, aligned=False)["W"] == 1
    x = torch.from_numpy(int8_inputs(N, D, seed=N + D)).cuda().to(dt)
    shifted = torch.empty(N * D + 1, dtype=dt, device="cuda")[1:]
    shifted = shifted.view(N, D).copy_(x)
    for t in (x, shifted):
        ops.reset_launches()
        q, s = ops.int8_quantize(t)
        wq, ws = ref.int8_quantize_ref(t)
        assert ops.launch_counts()["int8_quantize"] == 1
        assert torch.equal(q, wq), int((q != wq).sum())
        torch.testing.assert_close(s, ws, rtol=1e-6, atol=0)


# the tiansuan pair's decode shapes (B, H, Hkv, D = 48) at page size 16:
# the space-ground scheduler's main path on both tiers
TIANSUAN_HEADS = [(4, 2, 48), (8, 4, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", TIANSUAN_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_at_the_tiansuan_shapes(H, Hkv, D, dtype):
    """Sequences of the scheduler trace's lengths (prompt 8-40 plus up to
    32 new tokens, and 1) on shuffled 16-position pages, one launch,
    against the plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    lens = [1, 8, 16, 17, 40, 47, 64, 71]
    q, kp, vp, bt, kv_len = paged_lengths_inputs(lens, H, Hkv, D, 16, seed=H)
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp, bt, kv_len)]
    args[:3] = [a.to(dt) for a in args[:3]]
    ops.reset_launches()
    got = ops.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*args)
    assert ops.launch_counts()["paged_decode_attention"] == 1
    assert bool(torch.isfinite(got).all())
    tol = 2e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,D", TIANSUAN_HEADS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_one_sequence_at_the_tiansuan_shapes(H, Hkv, D, dtype):
    """One sequence (the speculative decoder's one-slot engines) of every
    length the draft engine's table holds, at the largest cluster the
    kernel takes: one launch each, against the plain version."""
    _need_cuda()
    dt = getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 1e-2
    for n in SINGLE_LENS:
        args = [torch.from_numpy(a).cuda() for a in paged_lengths_inputs(
            [n], H, Hkv, D, 16, seed=n, max_pages=SINGLE_PAGES)]
        args[:3] = [a.to(dt) for a in args[:3]]
        assert args[3].shape == (1, SINGLE_PAGES)
        ops.reset_launches()
        got = ops.paged_decode_attention(*args)
        assert ops.launch_counts()["paged_decode_attention"] == 1
        assert bool(torch.isfinite(got).all()), n
        torch.testing.assert_close(
            got.float(), ref.paged_decode_attention_ref(*args).float(),
            atol=tol, rtol=tol, msg=lambda m: f"kv_len {n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_graft_round_trip_on_a_cuda_pool(dtype):
    """A spill's host snapshot of CUDA pool pages grafts back into other
    pages bit for bit, with and without ``since``."""
    _need_cuda()
    from repro_torch.models import transformer as T
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    pool = {"blocks": {k: torch.randn((4, 12, 16, 2, 48), generator=g,
                                      device="cuda").to(dt)
                       for k in ("k", "v")}}
    snap = {n: {k: t.cpu() for k, t in d.items()} for n, d in
            T.extract_paged_cache(pool, [9, 3, 5]).items()}
    assert snap["blocks"]["k"].shape == (4, 1, 48, 2, 48)
    T.graft_paged_cache(pool, snap, [1, 2, 4])
    tail = T.extract_paged_cache(pool, [9, 3, 5], since=1)
    T.graft_paged_cache(pool, tail, [6, 7, 8], since=1)
    for k in ("k", "v"):
        p = pool["blocks"][k]
        assert torch.equal(p[:, [1, 2, 4]], p[:, [9, 3, 5]])
        assert torch.equal(p[:, [7, 8]], p[:, [3, 5]])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["spill", "resident"])
def test_preempt_resume_sweep_on_the_card(mode):
    """The tiansuan ONBOARD tier in fp32 on the card: a probe preempted
    mid-prefill and at every decode step (a filler churning the pool
    while it is out) and resumed gives the uninterrupted run's tokens,
    and the pool drains."""
    _need_cuda()
    from repro_torch.configs.tiansuan_pair import ONBOARD
    from repro_torch.models import transformer as T
    from repro_torch.serving.batching import Request
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.scheduler import PreemptiveScheduler
    cfg = ONBOARD.with_(param_dtype="float32", activation_dtype="float32")
    params = T.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(42)
    prompt = rng.integers(1, cfg.vocab_size, 21).astype(np.int32)
    filler = rng.integers(1, cfg.vocab_size, 9).astype(np.int32)
    max_new = 8
    kw = dict(n_slots=2, max_seq=64, prefill_budget_tokens=16)
    want = ContinuousEngine(cfg, params, **kw).run(
        [Request(prompt=prompt.copy(), max_new=max_new)])
    want = list(want.values())[0].tokens
    eng = ContinuousEngine(cfg, params, **kw)
    sched = PreemptiveScheduler(eng, preempt_mode=mode)
    for k in range(max_new - 1):
        probe = Request(prompt=prompt.copy(), max_new=max_new)
        sched.submit(probe)
        sched.step(decode=False)
        sched._admit_by_priority()
        for _ in range(k):                   # k = 0: mid-prefill (the
            sched.step()                     # 21-token prompt takes two
            #                                  chunks of 16)
        (slot,) = [s for s in eng.slots.active_slots()
                   if eng.slots.states[s].request.rid == probe.rid]
        sched.preempt(slot)
        sched.submit(Request(prompt=filler.copy(), max_new=3))
        sched.step()
        sched.step()
        res = sched.run()
        np.testing.assert_array_equal(res[probe.rid].tokens, want)
        alloc = eng.slots.allocator
        assert alloc.in_use == 0 and alloc.reserved == 0
    assert sched.n_resumes == sched.n_preemptions == max_new - 1


@pytest.mark.cuda
def test_two_rank_mesh_on_the_card_matches_one_rank():
    """A 2-rank gloo world on the card (both ranks on cuda:0) serves the
    reference test's dense trace (reduced fp32, 8/4 heads of 32: 4/2 a
    rank through the paged kernel) with the one-rank engine's tokens;
    each rank launches the paged kernel once a layer and decode step."""
    _need_cuda()
    import sharded_ranks as R
    from repro_torch.launch.mesh import spawn
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = R.serving_cfg("smollm-360m")
    tree = R.numpy_tree(T.init_params(cfg, seed=0, device="cpu"))
    eng = ContinuousEngine(cfg, R._params(tree, cfg, "cuda"), **R.ENGINE_KW)
    want = {rid: r.tokens for rid, r in eng.run(R.trace(cfg)).items()}
    outs = spawn(R.two_rank_cuda, 2, tree, device="cuda", timeout_s=300)
    for out in outs:
        assert out["tokens"].keys() == want.keys()
        for rid in want:
            np.testing.assert_array_equal(out["tokens"][rid], want[rid])
        assert out["drained"] and out["stats"]["n_kv_shards"] == 2
        assert out["launches"]["paged_decode_attention"] == \
            cfg.n_layers * out["decode_steps"] > 0


@pytest.mark.cuda
def test_gloo_collectives_of_card_tensors_cross_the_host():
    """4 ranks on cuda:0 under gloo, a (2, 2) mesh: the gather,
    reduce-scatter and all-to-all of CUDA tensors, staged through pinned
    host buffers, give every rank the exact gather (bit for bit, -0.0
    and NaN too), the exact sums of fp32 integers, and all-to-alls that
    deliver slice j from the rank at index j and round-trip bit for
    bit."""
    _need_cuda()
    import mesh_presets_ranks as R
    from repro_torch.launch.mesh import spawn
    ranks = spawn(R.card_collectives, 4, device="cuda", timeout_s=300)

    def bits(t):
        return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
            t.element_size()])

    def peers(r, axis):
        c = r["coord"]
        return [q for q in ranks if axis is None
                or q["coord"][{"data": "model", "model": "data"}[axis]]
                == c[{"data": "model", "model": "data"}[axis]]]
    for r in ranks:
        for axis, i, n, local, got in r["gather"]:
            parts = {}
            for q in peers(r, axis):
                for a, j, _, theirs, _ in q["gather"]:
                    if a == axis and theirs.dtype == local.dtype:
                        parts[j] = theirs
            want = torch.cat([parts[j] for j in range(n)])
            assert torch.equal(bits(got), bits(want)), (axis, local.dtype)
        for axis, i, n, got in r["reduce_scatter"]:
            total = sum((q["rank"] + 1) for q in peers(r, axis))
            want = torch.arange(n * 4, dtype=torch.float32)[
                4 * i:4 * (i + 1)] * total
            assert torch.equal(got, want), (axis, got, want)
        for axis, i, n, sent, once, twice in r["all_to_all"]:
            assert torch.equal(bits(twice), bits(sent))
            for q in peers(r, axis):
                for a, j, _, theirs, _, _ in q["all_to_all"]:
                    if a == axis and theirs.dtype == sent.dtype:
                        assert torch.equal(bits(once[j]), bits(theirs[i]))
