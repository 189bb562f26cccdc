"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and goes through these phases in
order, printing one JSON line for each:

  device       the card's name and power limit (nvidia-smi)
  build        nvcc builds every kernel of the port from csrc/, in parallel
  paged_decode_attention / confidence_gate
               each CUDA kernel against its plain PyTorch version on the
               card, at the main path's shapes and a few others, with its
               time, the plain version's, one library call's and the bound
  cross_check  smollm-360m widths at 4 layers in fp32 (TF32 off) serve the
               same requests on cuda and on cpu: identical greedy tokens,
               apart from counted near-ties
  full_serve   smollm-360m at full width and depth in bf16 serves 16
               requests through ContinuousEngine.run (8 slots, max_seq 2048)
               and the confidence gate decides every result; the kernels'
               launch counters are zeroed just before and read just after

Any failed check raises, so the script exits non-zero.  Without a GPU (or
without the rest of the repository beside it) it fails before printing any
result.  Its last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet) at its 700 W limit:
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # CUDA cores: both kernels do fp32 math
PAGE = 16
PAGED_SHAPES = [(8, 15, 5, 64), (8, 8, 4, 48), (4, 3, 1, 80)]   # B,H,Hkv,D
GATE_SHAPES = [(1, 49152), (8, 49152), (8, 512)]
PAGED_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
GATE_ATOL, ENTROPY_RTOL = 1e-5, 4e-6


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

_flush_buf = None


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls, each
    bracketed by CUDA events with the 50 MB L2 flushed before it (the
    main path reads every layer's pool slice cold).  The calls are queued
    behind a ~0.2 s spin kernel, so the device runs them back to back and
    the events hold device time only, not the host's time to launch."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)         # cycles: ~0.2 s at ~2 GHz
    evs = []
    for _ in range(iters):
        _flush_buf.fill_(1)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         per_kernel_s={k: v["seconds"] for k, v in out.items()},
         ptxas={k: [ln.strip() for ln in v["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in out.items()})


def _paged_case(B, H, Hkv, D, dtype, gen):
    """Ragged lengths (1, mid-page values, 2048) over shuffled pages of a
    2048-position table, and garbage in the scratch page 0."""
    max_pages = 2048 // PAGE
    lens = torch.tensor([1, 2048, 37, 1000, 511, 16, 1999, 260][:B],
                        dtype=torch.int32)
    need = [-(-int(n) // PAGE) for n in lens]
    n_pages = sum(need) + 1
    kp = torch.randn((n_pages, PAGE, Hkv, D), generator=gen)
    vp = torch.randn((n_pages, PAGE, Hkv, D), generator=gen)
    kp[0], vp[0] = 1e4, -1e4               # never read past kv_len
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    bt = torch.zeros((B, max_pages), dtype=torch.int32)
    i = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[i:i + n]
        i += n
    q = torch.randn((B, H, D), generator=gen)
    dev = dict(device="cuda")
    return (q.to(dtype=dtype, **dev), kp.to(dtype=dtype, **dev),
            vp.to(dtype=dtype, **dev), bt.to(**dev), lens.to(**dev))


def _sdpa_paged(q, kp, vp, bt, lens):
    """Library yardstick (timed only, never used by the port): gather the
    tables, then scaled_dot_product_attention with a length mask."""
    B, H, D = q.shape
    Hkv = kp.shape[2]
    kg = kp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, -1, Hkv, D).transpose(1, 2)
    mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kg, vg, attn_mask=mask, enable_gqa=True)[:, :, 0]


def phase_paged() -> dict:
    from repro_torch.kernels import paged_decode_attention as K
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    rows, main = [], None
    for B, H, Hkv, D in PAGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(B, H, Hkv, D, dtype, gen)
            got = K.paged_decode_attention_kernel(*args)
            want = ref.paged_decode_attention_ref(*args)
            torch.cuda.synchronize()
            atol, rtol = PAGED_TOL[dtype]
            err = (got.float() - want.float()).abs()
            excess = float((err - atol - rtol * want.float().abs()).max())
            check(bool(torch.isfinite(got).all()), "paged: non-finite")
            check(excess <= 0, f"paged {B,H,Hkv,D} {dtype}: max_abs_err "
                  f"{float(err.max())} over atol {atol} + rtol {rtol}")
            q, kp, vp, bt, lens = args
            item = kp.element_size()
            n_pos = int(lens.sum())
            n_bytes = (2 * n_pos * Hkv * D * item + 2 * q.numel() * item
                       + 4 * sum(-(-int(n) // PAGE) for n in lens) + 4 * B)
            n_ops = 4 * n_pos * H * D
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            row = dict(shape=[B, H, Hkv, D], dtype=str(dtype)[6:],
                       max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                       ms=time_ms(lambda: K.paged_decode_attention_kernel(
                           *args)),
                       plain_ms=time_ms(
                           lambda: ref.paged_decode_attention_ref(*args)),
                       library_ms=time_ms(lambda: _sdpa_paged(*args)),
                       bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            if (B, H, Hkv, D) == PAGED_SHAPES[0] and dtype == torch.bfloat16:
                main = row
    emit("paged_decode_attention", cases=rows)
    return main


def _gate_logits(B, V, gen):
    """Planted ties for the maximum (the first index must win): across a
    2048-wide vocab block edge in row 0, between neighbouring threads'
    elements in row 1, and at both ends of the last row."""
    x = torch.randn((B, V), generator=gen) * 3.0
    top = float(x.max()) + 1.0
    e = min(2048, V // 2)
    x[0, e - 1] = x[0, e] = top
    want = {0: e - 1}
    if B > 2:
        x[1, 5] = x[1, 6] = top
        want[1] = 5
    if B > 1:
        x[-1, 0] = x[-1, V - 1] = top
        want[B - 1] = 0
    return x.cuda(), want


def phase_gate() -> dict:
    from repro_torch.kernels import conf_gate as K
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(1)
    rows, main = [], None
    for B, V in GATE_SHAPES:
        x, ties = _gate_logits(B, V, gen)
        got, want = K.confidence_gate_kernel(x), ref.confidence_gate_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(got["argmax"], want["argmax"]),
              f"gate {B}x{V}: argmax {got['argmax'].tolist()} != "
              f"{want['argmax'].tolist()}")
        check(all(int(got["argmax"][r]) == i for r, i in ties.items()),
              f"gate {B}x{V}: the first index of a tie must win {ties}")
        errs = {}
        for k in ("max_prob", "entropy", "margin"):
            err = (got[k] - want[k]).abs()
            rtol = ENTROPY_RTOL if k == "entropy" else 0.0
            check(bool((err <= GATE_ATOL + rtol * want[k].abs()).all()),
                  f"gate {B}x{V} {k}: max_abs_err {float(err.max())}")
            errs[k] = float(err.max())
        b_ms, b_by = bound_ms(B * V * x.element_size() + 16 * B, 5 * B * V)
        row = dict(shape=[B, V], dtype="float32", max_abs_err=max(errs.values()),
                   errs=errs, atol=GATE_ATOL, entropy_rtol=ENTROPY_RTOL,
                   ms=time_ms(lambda: K.confidence_gate_kernel(x)),
                   plain_ms=time_ms(lambda: ref.confidence_gate_ref(x)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        if (B, V) == (1, 49152):
            main = row
    emit("confidence_gate", cases=rows)
    return main


def _requests(n, lo, hi, max_new, vocab, seed):
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new=max_new, arrival_t=0.5 * i)
            for i in range(n)]


def _next_logits(params, cfg, tokens: np.ndarray) -> torch.Tensor:
    """Next-token logits after ``tokens``, from one monolithic prefill
    chunk on a fresh pool (on the params' device)."""
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    n_pages = -(-len(tokens) // PAGE)
    pool = T.init_paged_cache(cfg, n_pages + 1, PAGE, device=dev)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.from_numpy(tokens.astype(np.int32))[None].to(dev)
    logits, _, _ = T.prefill_chunk(params, cfg, pool, toks, len(tokens), 0,
                                   bt)
    return logits[0, -1]


def phase_cross_check(device: str = "cuda") -> None:
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("smollm-360m").with_(
        n_layers=4, param_dtype="float32", activation_dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    reqs = _requests(6, 16, 96, 8, cfg.vocab_size, seed=5)
    out = {}
    for dev, params in (("cuda", _to(cpu_params, device)),
                        ("cpu", cpu_params)):
        eng = ContinuousEngine(cfg, params, n_slots=4, max_seq=256)
        res = eng.run([r.clone() for r in reqs])
        out[dev] = [res[rid].tokens for rid in sorted(res)]
    near_ties, first_diff = 0, []
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a != b))
        prefix = np.concatenate([reqs[i].prompt, b[:j]])
        top2 = torch.topk(_next_logits(cpu_params, cfg, prefix), 2).values
        gap = float(top2[0] - top2[1])
        first_diff.append(dict(request=i, position=j, top2_gap=gap))
        check(gap < 1e-4, f"cross-check: request {i} diverges at {j} with "
              f"a top-2 gap of {gap} (not a near-tie)")
        near_ties += 1
    emit("cross_check", n_requests=len(reqs), n_layers=cfg.n_layers,
         identical=len(reqs) - near_ties, near_ties=near_ties,
         divergences=first_diff, tf32=False)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_full_serve(cfg=None, device: str = "cuda") -> dict:
    from repro_torch.config import get_config
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousEngine
    cfg = cfg or get_config("smollm-360m")
    eng = ContinuousEngine.init(cfg, seed=0, device=device, n_slots=8,
                                max_seq=2048)
    reqs = _requests(16, 64, 512, 32, cfg.vocab_size, seed=7)
    gate = ConfidenceGate()
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    decisions = {rid: gate.decide(torch.from_numpy(r.logits_last[None])
                                  .to(device)) for rid, r in results.items()}
    escalated = sum(bool(d["escalate"][0]) for d in decisions.values())
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    n_tok = sum(len(r.tokens) for r in results.values())
    check(len(results) == len(reqs), "full serve: requests lost")
    for r in results.values():
        check(len(r.tokens) == 32, "full serve: wrong token count")
        check(bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "full serve: token out of vocab")
        check(r.logits_last.shape == (cfg.vocab_size,)
              and bool(np.isfinite(r.logits_last).all()),
              "full serve: non-finite final logits")
    check(counts["paged_decode_attention"] > 0
          and counts["confidence_gate"] > 0, f"kernels not launched {counts}")
    check(counts["paged_decode_attention"]
          == cfg.n_layers * eng.decode_steps_total,
          f"paged launches {counts['paged_decode_attention']} != "
          f"{cfg.n_layers} x {eng.decode_steps_total} decode steps")
    check(counts["confidence_gate"] == len(results), "gate launches")
    emit("full_serve", arch=cfg.name, n_layers=cfg.n_layers,
         n_requests=len(reqs), ticks=eng.clock,
         decode_steps=eng.decode_steps_total,
         prefill_tokens=eng.prefill_tokens_total, generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, launches=counts,
         escalated=escalated, peak_mem_bytes=peak,
         kv=eng.kv_cache_stats())
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch                               # noqa: F401
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build()
    paged = phase_paged()
    gate = phase_gate()
    phase_cross_check()
    counts = phase_full_serve()
    kernels = []
    for name, src, replaces, row in (
            ("paged_decode_attention",
             "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:79", paged),
            ("confidence_gate", "src/repro_torch/kernels/csrc/conf_gate.cu",
             "src/repro/kernels/conf_gate.py:86", gate)):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"],
                            shape=row["shape"], dtype=row["dtype"]))
    emit("done", seconds=time.perf_counter() - t0)
    print(dev["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
