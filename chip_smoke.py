"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports the port (``src/repro_torch``)
and nothing of JAX or of the JAX package, and goes through these phases in
order, printing one JSON line for each:

  device       the card's name and power limit (nvidia-smi)
  build        nvcc builds every kernel of the port from csrc/, in parallel
  paged_decode_attention / confidence_gate / flash_attention /
  decode_attention / ssm_chunk_scan
               each CUDA kernel against its plain PyTorch version on the
               card, at the main paths' shapes (smollm-360m's and
               zamba2-7b's: flash and decode also at 32 heads of 112; the
               gate also at the EO tiers' 8 classes and at space_ground's
               (1, 512)) and a few others,
               with its time, the plain version's, one library call's
               (none for the SSD scan, the gate and int8) and the bound;
               the gate also at eo_scene's largest pass (605, 8) and at a
               151936-wide vocab in fp32 and bf16, each case with the cut
               it took (plan), planted first-index ties and 20
               bit-identical repeats, the card's per-launch floor
               (torch.cuda._sleep(1) under the same timer) and one
               profiled call at (1, 49152) (one kernel); flash and the SSD
               scan also with the share of their tolerance each case
               uses, their achieved TFLOP/s, and the registers and
               spills ptxas reported for their bf16 (tensor-core) kernels;
               the two decode kernels then beyond the main paths
               (*_beyond lines): granite's 48 query heads over one KV
               head at D = 128 and an 8192-position cache, and (paged)
               the tiansuan pair's heads, 4/2 and 8/4 at D = 48 (timed,
               with the cut each kernel chose), kv_len at the edges of that
               cut's tile and cluster (page sizes 16 and 128), a page
               outside the pool (only its sequence NaN), and the same
               bits over 20 launches
  cross_check  smollm-360m widths at 4 layers in fp32 (TF32 off) serve the
               same requests through the paged and the contiguous
               ContinuousEngine on cuda and the paged one on cpu, and a
               same-length batch through ServingEngine on cuda and cpu:
               identical greedy tokens, apart from counted near-ties
  full_serve   smollm-360m at full width and depth in bf16 serves 16
               requests through the paged ContinuousEngine.run (8 slots,
               max_seq 2048) and the confidence gate decides every result;
               then one warm decode step of the run again, under
               torch.profiler (the device's busy share of its wall time,
               the decode kernel's microseconds, one launch a layer) and
               with every decode launch held to its plain version
  fixed_serve  the same model generates 32 tokens for a batch of 8
               1024-token prompts through ServingEngine.generate (flash
               prefill, contiguous decode) and the gate decides the batch;
               then the same prefill once under torch.profiler (the
               device's busy share of its wall time) and once with every
               flash launch held to its plain version on its own inputs,
               and one decode step as in full_serve
  contiguous_serve
               the full_serve requests through ContinuousEngine with
               kv_layout="contiguous"
  hybrid_cross_check
               zamba2-7b widths at 7 layers (one unit of 6 Mamba2 blocks
               and the shared attention block, plus a tail of 1) in fp32
               (TF32 off): ServingEngine and ContinuousEngine on cuda
               against the same engines on cpu, identical greedy tokens
               apart from counted near-ties
  hybrid_fixed_serve
               zamba2-7b uncut in bf16: ServingEngine.generate on 4
               prompts of 512 tokens, 32 new tokens, gated; then its
               prefill profiled and held to the plain versions as in
               fixed_serve (every flash and SSD launch), and one decode
               step with every decode launch held to its plain version
  hybrid_continuous_serve
               the same weights: 8 requests of 64 to 768 prompt tokens
               (lengths the reference admits), 16 to 32 new tokens,
               through ContinuousEngine (4 slots, max_seq 1024; the
               contiguous SlotManager), every result gated
  eo_figures   the paper's EO case study at the JAX package's benchmark
               sizes and seeds, tiers trained in torch on the card: Figure
               6's filter rates (equal to the port's on the cpu), Figure
               7's in-orbit and collaborative accuracy, and the data
               reduction (197,120 bytes downlinked, 49,728 with the int8
               payload), each beside the reference's result and the paper's
  eo_cross_check
               data_reduction's tiers run the EO pipeline on 600 V1 tiles
               on cuda and on cpu in fp32 (TF32 off): identical masks,
               escalations, ledgers and int8 payloads, predictions apart
               from counted near-ties
  eo_scene     65,536 V1 tiles (64 frames of 1024 x 1024 on the card, 805
               MB) in passes of 4 frames: split_batch, filter_tiles, the
               onboard tier, the gate, the int8 escalation payload and the
               ground tier; tiles/s, CUDA-event time per stage, bytes
               against bent-pipe, the ledger's energy, peak memory
  int8_quantize
               the int8 kernel against its plain version (q bit for bit)
               at eo_scene's largest escalated payload (run alone, as by
               repro_torch.tools.compare_kernels: rows of that shape from
               tests/torch_inputs.py), the reference test's shapes, odd
               shapes, an odd width (the scalar path) and planted .5 ties,
               timed, each with the cut it took, and the launch floor
  space_ground the system's own main path: SpaceGroundScheduler over the
               tiansuan pair (ONBOARD 4 x 192, GROUND 12 x 384, vocab 512)
               in bf16 under every configs/tiansuan_pair.py SCHEDULER
               default (overlapped transmit/compute lanes, a 2-page hold,
               delta spills, a prefill budget of 16, framed ARQ at
               1024-byte frames, a checkpoint every 64 ticks, speculative
               draft-id escalation with draft_k 8) and the cascade's gate
               at 0.62: 16 requests arriving around the first pass's
               opening; spills, delta spills, resumes and checkpoints,
               drained pools, paged-decode launches = 4 x satellite + 12 x
               ground decode steps, one gate launch per classified
               sequence; wall time, ticks, tokens/s, the ledger (bytes,
               joules), checkpoint bytes and seconds, spill bytes against
               full spills, peak memory (the paged kernel at the pair's
               D = 48 heads and the gate at (1, 512) are timed in their
               kernel phases)
  space_ground_faults
               benchmarks/serving_throughput.py's fault replay on the
               tiansuan pair in fp32: frame loss and corruption, truncated
               passes, corrupted spill merges and a crash at tick 25 with
               a checkpoint every 8 ticks; token-exact with the fault-free
               run, every corruption detected, the frame ledger conserved,
               one reboot whose old engine is freed; then the same replay
               on the cpu (near-ties counted)
Each serve phase (and eo_scene) zeroes the kernels' launch counters just
before it and reads them just after, and checks them against the path's
prefills and decode steps (zamba2-7b: 81 SSD scans and 13 flash launches
per prefill, 13 decode launches per decode step; eo_scene: one gate per
pass and one int8 per pass with escalations; space_ground: as above).

Any failed check raises, so the script exits non-zero.  Without a GPU (or
without the rest of the repository beside it) it fails before printing any
result.  Its last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet) at its 700 W limit:
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # CUDA cores: exact fp32 math
BF16_FLOP_PER_S = 989e12           # tensor cores, dense
PAGE = 16
PAGED_SHAPES = [(8, 15, 5, 64), (8, 8, 4, 48), (4, 3, 1, 80)]   # B,H,Hkv,D
# the LM gate (smollm's vocab), then the EO gate's 8 classes: a whole
# pass of eo_scene's tiles (the most a pass could send the gate) and an
# odd count; then the largest pass eo_scene's gate gets (its filter
# survivors, 365-605 rows; that phase holds each of those launches'
# inputs against the plain version too) and a 151936-wide vocab (the
# largest the reference's gate is sized for), these two in fp32 and bf16;
# and the tiansuan pair's vocab at one row, the call space_ground makes
# for each finished satellite sequence: (B, V, dtypes)
GATE_SHAPES = [(1, 49152, ("float32",)), (8, 49152, ("float32",)),
               (8, 512, ("float32",)), (4096, 8, ("float32",)),
               (37, 8, ("float32",)), (605, 8, ("float32", "bfloat16")),
               (1, 151936, ("float32", "bfloat16")), (1, 512, ("float32",))]
# (B, S, H, Hkv, D): the fixed-slot prefill and decode of smollm-360m at
# 8 x 1024 / a 2048-position cache first, then two odd shapes, then
# zamba2-7b's shared attention in hybrid_fixed_serve (4 x 512 prompts, a
# 1024-position cache); flash also at lengths shorter than one 64-key
# tile and one past it, at g = 3 and at D = 112, and at the head sizes
# the bf16 kernel takes that no config uses (16, 32, 96, 128)
FLASH_SHAPES = [(8, 1024, 15, 5, 64), (2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                (4, 512, 32, 32, 112), (2, 1, 15, 5, 64), (2, 17, 15, 5, 64),
                (2, 65, 15, 5, 64), (2, 1, 8, 8, 112), (2, 17, 8, 8, 112),
                (2, 65, 8, 8, 112), (2, 130, 6, 2, 16), (2, 150, 4, 1, 32),
                (2, 120, 8, 4, 96), (2, 200, 4, 2, 128)]
FLASH_TIMED_MIN_S = 128            # shorter shapes time only the launch
DECODE_SHAPES = [(8, 2048, 15, 5, 64), (2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                 (4, 1024, 32, 32, 112)]
# (B, S, H, P, N, G, chunk, strong decay, views): zamba2-7b's prefill in
# hybrid_fixed_serve (4 x 512 tokens, two chunks) and its longest
# continuous admission (768 tokens, three chunks), with x, B and C cut
# as views from one (B, S, H*P + 2*G*N) tensor as mamba2_fwd cuts them
# (B/C at group level, G = 1); then zamba2's widths at 512 tokens on
# contiguous tensors, the reduced config's widths, a prompt shorter than
# the chunk, N = 128 over three chunks, a decay (A = -16, dt ~ 6) whose
# unmasked exp would overflow, and P = 128 with N = 64 and N = 128 (the
# bf16 kernel's wide register tiles; no config uses them)
SSM_SHAPES = [(4, 512, 112, 64, 64, 1, 256, False, True),
              (1, 768, 112, 64, 64, 1, 256, False, True),
              (1, 512, 112, 64, 64, 1, 256, False, False),
              (2, 128, 8, 32, 16, 8, 64, False, False),
              (1, 200, 5, 48, 16, 5, 256, False, False),
              (2, 768, 8, 64, 128, 2, 256, False, False),
              (2, 256, 4, 32, 16, 4, 64, True, False),
              (1, 256, 4, 128, 64, 1, 256, False, True),
              (1, 384, 4, 128, 128, 2, 128, False, False)]
SSM_TOL = (1e-3, 1e-4)             # atol, rtol: fp32 sums in another order
# On zamba2's own path (random weights, 81 layers) the scan sees |y| up
# to ~2e6, and there the fp32 plain version is itself up to ~500 from
# its float64 run (mostly the fp32 cumsum of dt * A, |l| up to ~3e4).
# So each launch on that path is held to the float64 plain version: its
# error at most this many times the fp32 plain version's own, plus
# SSM_TOL's atol.  Measured on an H100 with repro_torch.tools.
# compare_kernels: the sound kernel's worst launch errs 4.30x the plain
# version (it would fail a factor of 4.3 or less); with W's TF32 lo
# half dropped from the output kernel one launch errs 0.0873 where
# plain errs 0.00178 (the fault fails any factor below 48); a wrong
# carried state errs 2e5x.  16 sits between, ~3.7x from the first and
# ~3x from the second.  Faults below atol (h_in's lo half dropped) pass
# here and fail the ssm_chunk_scan phase at SSM_TOL.
SSD_PATH_FACTOR = 16.0
FLASH_MASKS = [(True, 0), (False, 0), (True, 64)]              # causal, window
KV_LENS = [1, 2048, 37, 1000, 511, 16, 1999, 260]
# Both decode kernels beyond the main paths, timed: granite-20b/34b's 48
# query heads over one KV head at D = 128 on smollm's lengths, and a
# cache of 8192 positions (each CTA of a cluster loops over tiles):
# (name, (H, Hkv, D), lengths, positions in the cache)
DECODE_WIDE = [("granite_group", (48, 1, 128), KV_LENS, 2048),
               ("cache_8192", (15, 5, 64),
                [8192, 8191, 4097, 1, 777, 8000, 3, 6000], 8192)]
DECODE_REPEATS = 20                # launches that must repeat the first's bits
# the paged kernel at the tiansuan pair's heads (ONBOARD 4/2, GROUND 8/4,
# D = 48; page size 16) over space_ground's lengths (prompts of 8-40 and
# up to 32 new tokens), timed: (name, (H, Hkv, D), lengths)
TIANSUAN_PAGED = [("tiansuan_onboard", (4, 2, 48),
                   [1, 8, 16, 17, 40, 47, 64, 71]),
                  ("tiansuan_ground", (8, 4, 48),
                   [1, 8, 16, 17, 40, 47, 64, 71])]
# the decode step (0-based) each serve phase keeps for _decode_checks: a
# warm one, every slot of full_serve busy
CAPTURE_STEP = 16
PAGED_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
GATE_ATOL, ENTROPY_RTOL = 1e-5, 4e-6
GATE_REPEATS = 20                  # launches that must repeat the first's bits
NEAR_TIE = 1e-4
INT8_SCALE_RTOL = 1e-6

# The EO case study, at the JAX package's benchmark sizes and seeds
# (benchmarks/fig6_filter_rate.py, fig7_accuracy.py, data_reduction.py)
EO_TILE = 32
FIG7_REGIMES = {
    "v1": dict(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.42,
               noise=0.26, seed=21),
    "v2": dict(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.58,
               noise=0.20, seed=22)}
FIG7_BUDGET = {"v1": 0.45, "v2": 0.26}
DR_TRAIN = dict(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.9,
                noise=0.22, seed=31)
DR_BUDGET = 0.35
DR_BYTES = {False: 197_120, True: 16 * (3072 + 4) + 32 * 16}   # 49,728
# the JAX package's own results on the CPU at these sizes, and the paper's
REFERENCE = {"fig6_filter_rate": {"v1": 0.902, "v2": 0.370},
             "fig7": {"v1": dict(acc_inorbit=0.276, acc_collaborative=0.418,
                                 relative_gain=0.514, escalation_rate=0.45),
                      "v2": dict(acc_inorbit=0.354, acc_collaborative=0.524,
                                 relative_gain=0.480, escalation_rate=0.26)},
             "data_reduction": dict(bytes_downlinked=197_120,
                                    bytes_bent_pipe=6_144_000,
                                    reduction=0.968, filter_rate=0.904,
                                    escalation_rate=0.333)}
PAPER = {"fig6_filter_rate": {"v1": 0.90, "v2": 0.40},
         "fig7_relative_gain": {"v1": 0.44, "v2": 0.52},
         "data_reduction": 0.90}
# eo_scene: 65,536 V1 tiles (805 MB of fp32 imagery, ~40 % of the ~2 GB
# an orbit images in benchmarks/table1_link_budget.py) as 64 frames of
# 1024 x 1024, four frames a pass
SCENE_FRAMES, SCENE_FRAME, SCENE_PASS = 64, 1024, 4
# the largest escalated payload of eo_scene's passes (235 tiles of 32 x 32
# x 3): phase_int8's main case when it runs alone
EO_PAYLOAD = (235, 3072)

# space_ground: the tiansuan pair (ONBOARD 4 x 192, GROUND 12 x 384, both
# vocab 512) in bf16 under every SCHEDULER default, serving SG_REQUESTS
# requests whose arrivals straddle the first pass's opening (SG_LEAD ticks
# before it, SG_GAP ticks apart; every third at priority 1, so blocked
# high-priority arrivals spill low-priority sequences again and those
# re-spills ship deltas); the satellite pool (SG_SAT_POOL pages of 16)
# is small enough that the pass's 2-page hold spills live sequences
SG_REQUESTS, SG_PROMPTS, SG_MAX_NEW = 16, (8, 40), (16, 32)
SG_SLOTS, SG_MAX_SEQ, SG_SAT_POOL = 8, 128, 16
SG_LEAD, SG_GAP, SG_SEED = 20, 2.5, 11
# satellite ticks of space_ground's profiled replay under torch.profiler
# (from the first tick with work): the profiler took ~45 s to stop after a
# whole replay, ~9 s after 10 ticks, on the host of an NVIDIA H100 80GB
# HBM3 machine (700 W)
SG_PROFILE_TICKS = 10
# space_ground_faults: benchmarks/serving_throughput.py's fault replay
# (FR_* there, _serve_fault) on the tiansuan pair in fp32
FR_PLAN = dict(seed=0, frame_loss_rate=0.25, frame_corrupt_rate=0.2,
               truncate_every=3, spill_corrupt_every=2, crash_at_tick=25)
FR_FRAME_BYTES, FR_MAX_RETRIES, FR_CHECKPOINT_EVERY = 32, 6, 8
FR_SAT_SLOTS, FR_SAT_POOL_PAGES, FR_SAT_PAGE_SIZE = 2, 9, 8
FR_RESERVE_PAGES, FR_GATE_THRESHOLD, FR_MAX_SEQ = 4, 0.6, 64


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


def profile_device(fn, reps: int = 5, calls: dict = None) -> tuple:
    """Device microseconds a call of ``fn`` spends in each CUDA kernel
    (and copy), by name, from torch.profiler over ``reps`` warm calls
    (L2 not flushed; {} if the profiler records no device time), and
    the call's wall microseconds under the profiler, from a sync before
    the first call to a sync after the last.  ``calls``, if given,
    receives each name's launches per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6 / reps
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t > 0:
            out[ev.key[:120]] = t / reps
            if calls is not None:
                calls[ev.key[:120]] = ev.count / reps
    return out, wall_us


def bound_ms(n_bytes: float, n_ops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_excess(got, want, atol, rtol) -> tuple:
    """(max |got - want|, max of it over atol + rtol * |want|)."""
    err = (got.float() - want.float()).abs()
    return (float(err.max()),
            float((err - atol - rtol * want.float().abs()).max()))


def _share_of_tolerance(got, want, atol, rtol) -> float:
    """The largest |got - want| / (atol + rtol * |want|): 1.0 uses the
    whole tolerance."""
    err = (got.float() - want.float()).abs()
    return float((err / (atol + rtol * want.float().abs())).max())


def _ptxas_summary(log: str) -> list:
    """Registers, shared memory and spills of each kernel that ptxas
    compiled, from nvcc's -Xptxas -v output."""
    rows, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = dict(function=m.group(1))
            rows.append(fn)
        elif fn is not None and ("registers" in ln or "spill" in ln):
            key = "registers" if "registers" in ln else "spills"
            fn[key] = ln.split(":", 1)[-1].strip()
    return rows


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


def phase_build() -> dict:
    """Builds every kernel; returns each library's ptxas summary."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    out = build.build()
    ptxas = {k: _ptxas_summary(v["ptxas"]) for k, v in out.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_kernel_s={k: v["seconds"] for k, v in out.items()},
         ptxas=ptxas)
    return ptxas


def _paged_case(B, H, Hkv, D, dtype, gen, lens=None, ps=PAGE):
    """Ragged lengths (by default 1, mid-page values and 2048 over a
    2048-position table) over shuffled pages of ps positions, the table
    as wide as the longest, and garbage in the scratch page 0."""
    lens = torch.tensor(KV_LENS[:B] if lens is None else lens,
                        dtype=torch.int32)
    max_pages = -(-int(lens.max()) // ps)
    need = [-(-int(n) // ps) for n in lens]
    n_pages = sum(need) + 1
    kp = torch.randn((n_pages, ps, Hkv, D), generator=gen)
    vp = torch.randn((n_pages, ps, Hkv, D), generator=gen)
    kp[0], vp[0] = 1e4, -1e4               # never read past kv_len
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    bt = torch.zeros((len(lens), max_pages), dtype=torch.int32)
    i = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[i:i + n]
        i += n
    q = torch.randn((len(lens), H, D), generator=gen)
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


def _decode_row(kernel, plain, library, args, shape) -> dict:
    """One decode kernel call held to its plain version at PAGED_TOL,
    then timed beside the plain version and the library call, with its
    bound: each valid K/V row read once, q read and out written once
    (and, paged, the table entries that hold the positions); the
    operations at the peak rate of q's type."""
    q, k, lens = args[0], args[1], args[-1]
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    atol, rtol = PAGED_TOL[q.dtype]
    err, excess = _max_excess(got, want, atol, rtol)
    check(bool(torch.isfinite(got).all()), f"decode {shape}: non-finite")
    check(excess <= 0, f"decode {shape} {q.dtype}: max_abs_err {err} over "
          f"atol {atol} + rtol {rtol}")
    B, H, D = q.shape
    Hkv, item = k.shape[2], k.element_size()
    n_pos = int(lens.sum())
    n_bytes = 2 * n_pos * Hkv * D * item + 2 * q.numel() * item + 4 * B
    if len(args) == 5:                       # paged: the table entries read
        ps = k.shape[1]
        n_bytes += 4 * sum(-(-int(n) // ps) for n in lens)
    peak = (BF16_FLOP_PER_S if q.dtype == torch.bfloat16
            else FP32_FLOP_PER_S)
    b_ms, b_by = bound_ms(n_bytes, 4 * n_pos * H * D, peak)
    return dict(shape=shape, dtype=str(q.dtype)[6:], max_abs_err=err,
                atol=atol, rtol=rtol,
                share_of_tolerance=_share_of_tolerance(got, want, atol, rtol),
                ms=time_ms(lambda: kernel(*args)),
                plain_ms=time_ms(lambda: plain(*args)),
                library_ms=library and time_ms(lambda: library(*args)),
                bound_ms=b_ms, bound_by=b_by)


def _torch_inputs():
    """tests/torch_inputs.py: the inputs and case lists the card tests
    (tests/test_torch_cuda.py) share with this script."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_inputs
    return torch_inputs


def _repeats(fn, args) -> bool:
    """DECODE_REPEATS more launches give the first launch's bits."""
    first = fn(*args)
    return all(torch.equal(fn(*args), first) for _ in range(DECODE_REPEATS))


def phase_paged() -> dict:
    from repro_torch.kernels import paged_decode_attention as K
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(0)
    rows, main = [], None
    for B, H, Hkv, D in PAGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(B, H, Hkv, D, dtype, gen)
            row = _decode_row(K.paged_decode_attention_kernel,
                              ref.paged_decode_attention_ref, _sdpa_paged,
                              args, [B, H, Hkv, D])
            rows.append(row)
            if (B, H, Hkv, D) == PAGED_SHAPES[0] and dtype == torch.bfloat16:
                main = row
    emit("paged_decode_attention", cases=rows)
    _paged_beyond(K, ref, gen)
    return main


def _paged_beyond(K, ref, gen) -> None:
    """The paged kernel beyond the main path's shapes: granite's group
    and an 8192-position cache (timed), the tile and cluster edges at
    page sizes 16 and 128, a page outside the pool, repeated bits."""
    TI = _torch_inputs()
    wide, edges = [], []
    for name, (H, Hkv, D), lens, _ in DECODE_WIDE:
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(len(lens), H, Hkv, D, dtype, gen, lens=lens)
            row = _decode_row(K.paged_decode_attention_kernel,
                              ref.paged_decode_attention_ref, _sdpa_paged,
                              args, [len(lens), H, Hkv, D])
            row.update(name=name, kv_len=list(lens), cut=K.plan(
                len(lens), H, Hkv, D, PAGE, args[3].shape[1], dtype))
            wide.append(row)
    tiansuan = []
    for name, (H, Hkv, D), lens in TIANSUAN_PAGED:
        for dtype in (torch.bfloat16, torch.float32):
            args = _paged_case(len(lens), H, Hkv, D, dtype, gen, lens=lens)
            row = _decode_row(K.paged_decode_attention_kernel,
                              ref.paged_decode_attention_ref, _sdpa_paged,
                              args, [len(lens), H, Hkv, D])
            row.update(name=name, kv_len=list(lens), cut=K.plan(
                len(lens), H, Hkv, D, PAGE, args[3].shape[1], dtype))
            tiansuan.append(row)
    for H, Hkv, D in TI.EDGE_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            for ps in TI.EDGE_PAGE_SIZES:
                cut = K.plan(8, H, Hkv, D, ps, -(-2048 // ps), dtype)
                lens = TI.edge_lengths(cut["C"], cut["tile"])
                args = _paged_case(8, H, Hkv, D, dtype, gen, lens=lens,
                                   ps=ps)
                atol, rtol = PAGED_TOL[dtype]
                share = _share_of_tolerance(
                    K.paged_decode_attention_kernel(*args),
                    ref.paged_decode_attention_ref(*args), atol, rtol)
                check(share <= 1.0, f"paged edges {H, Hkv, D} {dtype} page "
                      f"{ps} kv_len {lens}: share {share}")
                edges.append(dict(heads=[H, Hkv, D], dtype=str(dtype)[6:],
                                  page_size=ps, cut=cut, kv_len=lens,
                                  share_of_tolerance=share))
    # a table entry outside the pool, inside two sequences' lengths: those
    # sequences' rows NaN (every head), the others untouched
    args = list(_paged_case(8, 15, 5, 64, torch.bfloat16, gen))
    good = args[3].clone()
    args[3][1, 40] = args[1].shape[0] + 7
    args[3][6, 0] = -3
    got = K.paged_decode_attention_kernel(*args)
    args[3] = good
    want = ref.paged_decode_attention_ref(*args)
    rest = [0, 2, 3, 4, 5, 7]
    bad_ok = bool(torch.isnan(got[[1, 6]]).all()) and _share_of_tolerance(
        got[rest], want[rest], *PAGED_TOL[torch.bfloat16]) <= 1.0
    check(bad_ok, "paged: a page outside the pool must make only its "
          "sequence's rows NaN")
    repeats = {}
    for H, Hkv, D in ((15, 5, 64), (48, 1, 128)):
        args = _paged_case(8, H, Hkv, D, torch.bfloat16, gen)
        repeats[f"{H}/{Hkv}/{D}"] = _repeats(K.paged_decode_attention_kernel,
                                             args)
    check(all(repeats.values()), f"paged: bits differ across launches "
          f"{repeats}")
    emit("paged_decode_attention_beyond", wide=wide, tiansuan=tiansuan,
         edges=edges,
         bad_page_only_its_sequence_nan=bad_ok,
         repeats_bits_over=DECODE_REPEATS, repeats=repeats)


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


def _check_gate(got, want, what) -> tuple:
    """The gate kernel's dict against the plain version's on the same
    logits: argmax exact, max_prob and margin within GATE_ATOL, entropy
    within GATE_ATOL + ENTROPY_RTOL * |entropy|.  Returns each metric's
    max_abs_err and the largest share of its tolerance used."""
    sync()
    check(torch.equal(got["argmax"], want["argmax"]),
          f"{what}: argmax {got['argmax'].tolist()} != "
          f"{want['argmax'].tolist()}")
    errs, used = {}, 0.0
    for k in ("max_prob", "entropy", "margin"):
        err = (got[k] - want[k]).abs()
        rtol = ENTROPY_RTOL if k == "entropy" else 0.0
        tol = GATE_ATOL + rtol * want[k].abs()
        check(bool((err <= tol).all()),
              f"{what} {k}: max_abs_err {float(err.max())}")
        errs[k] = float(err.max()) if err.numel() else 0.0
        used = max(used, float((err / tol).max()) if err.numel() else 0.0)
    return errs, used


def _plan(K, *args, **kw):
    """``K.plan(...)``: the cut the kernel takes; None for a kernel
    library without a plan function (an older csrc/ tree that
    repro_torch.tools.compare_kernels runs under these wrappers; main()
    requires the plans)."""
    try:
        return K.plan(*args, **kw)
    except AttributeError:
        return None


def launch_floor_ms() -> float:
    """The card's per-launch floor under ``time_ms``: one launch of a
    kernel that does next to nothing (``torch.cuda._sleep(1)``)."""
    return time_ms(lambda: torch.cuda._sleep(1))


def _profiled_once(fn, what: str) -> dict:
    """The CUDA kernels one call of ``fn`` runs, by name (device µs),
    under torch.profiler; fails unless there is exactly one, launched
    once a call."""
    calls = {}
    us, _ = profile_device(fn, calls=calls)
    check(len(us) == 1 and all(n == 1 for n in calls.values()),
          f"{what}: one call ran {calls} (want one kernel, launched once)")
    return us


def phase_gate() -> dict:
    from repro_torch.kernels import conf_gate as K
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(1)
    rows, main, profiled = [], None, None
    for B, V, dtypes in GATE_SHAPES:
        x32, ties = _gate_logits(B, V, gen)
        for dtype in dtypes:
            x = x32.to(getattr(torch, dtype))
            what = f"gate {B}x{V} {dtype}"
            got = K.confidence_gate_kernel(x)
            want = ref.confidence_gate_ref(x)
            errs, used = _check_gate(got, want, what)
            check(all(int(got["argmax"][r]) == i for r, i in ties.items()),
                  f"{what}: the first index of a tie must win {ties}")
            again = [K.confidence_gate_kernel(x) for _ in range(GATE_REPEATS)]
            sync()
            check(all(torch.equal(a[k], got[k]) for a in again for k in got),
                  f"{what}: {GATE_REPEATS} more launches on the same "
                  f"logits are not bit-identical to the first")
            b_ms, b_by = bound_ms(B * V * x.element_size() + 16 * B,
                                  5 * B * V)
            row = dict(shape=[B, V], dtype=dtype,
                       plan=_plan(K, B, V, x.dtype),
                       max_abs_err=max(errs.values()), errs=errs,
                       atol=GATE_ATOL, entropy_rtol=ENTROPY_RTOL,
                       share_of_tolerance=used,
                       repeats_identical=GATE_REPEATS,
                       ms=time_ms(lambda: K.confidence_gate_kernel(x)),
                       plain_ms=time_ms(lambda: ref.confidence_gate_ref(x)),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            if (B, V, dtype) == (1, 49152, "float32"):
                main = row
                profiled = _profiled_once(
                    lambda: K.confidence_gate_kernel(x), what)
    emit("confidence_gate", cases=rows, launch_floor_ms=launch_floor_ms(),
         profiled_main_call_us=profiled)
    return main


def _pairs(S, causal, window) -> int:
    """(query, key) pairs the masks keep, for one (batch, head)."""
    if not causal and not window:
        return S * S
    n = 0
    for qp in range(S):
        hi = qp + 1 if causal else S
        lo = max(0, qp - window + 1) if window else 0
        n += hi - lo
    return n


def phase_flash(ptxas: dict) -> dict:
    """The flash kernel against its plain version, causal, non-causal and
    windowed, in bf16 (tensor cores) and fp32 (CUDA cores), with the
    share of the tolerance each case uses; timed (with SDPA's time on
    pre-transposed inputs as the library yardstick) and its achieved
    TFLOP/s for the causal cases of S >= FLASH_TIMED_MIN_S.  Also prints
    the registers and spills ptxas reported for the bf16 kernel."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(2)
    rows, main = [], None
    for B, S, H, Hkv, D in FLASH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, S, H, D), generator=gen).to("cuda", dtype)
            k, v = (torch.randn((B, S, Hkv, D), generator=gen)
                    .to("cuda", dtype) for _ in range(2))
            atol, rtol = PAGED_TOL[dtype]
            for causal, window in FLASH_MASKS:
                kw = dict(causal=causal, window=window)
                got = K.flash_attention_kernel(q, k, v, **kw)
                want = ref.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err, excess = _max_excess(got, want, atol, rtol)
                check(bool(torch.isfinite(got).all()), "flash: non-finite")
                check(excess <= 0, f"flash {B,S,H,Hkv,D} {dtype} {kw}: "
                      f"max_abs_err {err} over atol {atol} + rtol {rtol}")
                row = dict(shape=[B, S, H, Hkv, D], dtype=str(dtype)[6:],
                           causal=causal, window=window, max_abs_err=err,
                           atol=atol, rtol=rtol,
                           share_of_tolerance=_share_of_tolerance(
                               got, want, atol, rtol))
                if causal and not window and S >= FLASH_TIMED_MIN_S:
                    item = q.element_size()
                    n_bytes = item * 2 * (q.numel() + k.numel())
                    n_ops = 4 * B * H * D * _pairs(S, causal, window)
                    peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                            else FP32_FLOP_PER_S)
                    b_ms, b_by = bound_ms(n_bytes, n_ops, peak)
                    qt, kt, vt = (t.transpose(1, 2).contiguous()
                                  for t in (q, k, v))
                    ms = time_ms(lambda: K.flash_attention_kernel(
                        q, k, v, **kw))
                    row.update(
                        ms=ms, tflop_per_s=n_ops / ms / 1e9,
                        plain_ms=time_ms(lambda: ref.flash_attention_ref(
                            q, k, v, **kw), iters=10),
                        library_ms=time_ms(
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True,
                                enable_gqa=True)),
                        bound_ms=b_ms, bound_by=b_by,
                        bound_peak_flop_per_s=peak)
                    if (B, S, H, Hkv, D) == FLASH_SHAPES[0] \
                            and dtype == torch.bfloat16:
                        main = row
                rows.append(row)
    emit("flash_attention", cases=rows,
         ptxas_bf16=[f for f in ptxas.get("flash_attention", [])
                     if "bf16" in f["function"]])
    return main


def _decode_case(B, S, H, Hkv, D, dtype, gen, lens=None):
    """A contiguous cache with ragged lengths (by default KV_LENS) and
    1e4 planted in K and V past every length (a read past kv_len would
    show)."""
    lens = torch.tensor([min(n, S) for n in (KV_LENS if lens is None
                                             else lens)[:B]],
                        dtype=torch.int32)
    k = torch.randn((B, S, Hkv, D), generator=gen)
    v = torch.randn((B, S, Hkv, D), generator=gen)
    past = torch.arange(S)[None, :] >= lens[:, None]
    k[past], v[past] = 1e4, 1e4
    q = torch.randn((B, H, D), generator=gen)
    return (q.to("cuda", dtype), k.to("cuda", dtype), v.to("cuda", dtype),
            lens.cuda())


def _sdpa_decode(q, k, v, lens):
    """Library yardstick (timed only, never used by the port): a
    function of the kernel's arguments that runs
    scaled_dot_product_attention with a length mask over (B, Hkv, S, D)
    copies of the cache, made here once (not timed)."""
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return lambda *_: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0]


def phase_decode() -> dict:
    from repro_torch.kernels import decode_attention as K
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(3)
    rows, main = [], None
    for B, S, H, Hkv, D in DECODE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _decode_case(B, S, H, Hkv, D, dtype, gen)
            row = _decode_row(K.decode_attention_kernel,
                              ref.decode_attention_ref, _sdpa_decode(*args),
                              args, [B, S, H, Hkv, D])
            row["kv_len"] = args[3].tolist()
            rows.append(row)
            if (B, S, H, Hkv, D) == DECODE_SHAPES[0] \
                    and dtype == torch.bfloat16:
                main = row
    emit("decode_attention", cases=rows)
    _decode_beyond(K, ref, gen)
    return main


def _decode_beyond(K, ref, gen) -> None:
    """The contiguous kernel beyond the main paths' shapes: granite's
    group and an 8192-position cache (timed), the tile and cluster
    edges, repeated bits."""
    TI = _torch_inputs()
    wide, edges = [], []
    for name, (H, Hkv, D), lens, S in DECODE_WIDE:
        for dtype in (torch.bfloat16, torch.float32):
            args = _decode_case(len(lens), S, H, Hkv, D, dtype, gen,
                                lens=lens)
            row = _decode_row(K.decode_attention_kernel,
                              ref.decode_attention_ref, _sdpa_decode(*args),
                              args, [len(lens), S, H, Hkv, D])
            row.update(name=name, kv_len=list(lens),
                       cut=K.plan(len(lens), H, Hkv, D, S, dtype))
            wide.append(row)
    for H, Hkv, D in TI.EDGE_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            cut = K.plan(8, H, Hkv, D, 4096, dtype)
            lens = TI.edge_lengths(cut["C"], cut["tile"])
            args = _decode_case(8, max(lens), H, Hkv, D, dtype, gen,
                                lens=lens)
            atol, rtol = PAGED_TOL[dtype]
            share = _share_of_tolerance(K.decode_attention_kernel(*args),
                                        ref.decode_attention_ref(*args),
                                        atol, rtol)
            check(share <= 1.0, f"decode edges {H, Hkv, D} {dtype} kv_len "
                  f"{lens}: share {share}")
            edges.append(dict(heads=[H, Hkv, D], dtype=str(dtype)[6:],
                              cut=cut, kv_len=lens,
                              share_of_tolerance=share))
    repeats = {}
    for H, Hkv, D in ((15, 5, 64), (48, 1, 128)):
        args = _decode_case(8, 2048, H, Hkv, D, torch.bfloat16, gen)
        repeats[f"{H}/{Hkv}/{D}"] = _repeats(K.decode_attention_kernel, args)
    check(all(repeats.values()), f"decode: bits differ across launches "
          f"{repeats}")
    emit("decode_attention_beyond", wide=wide, edges=edges,
         repeats_bits_over=DECODE_REPEATS, repeats=repeats)


def _ssm_case(B, S, H, P, N, G, strong, views, dtype, gen):
    """x (B,S,H,P), B/C (B,S,G,N) in ``dtype``; dt (B,S,H) post-softplus
    and A (H,) < 0 in fp32, on the card.  ``views``: x, B and C are cut
    from one (B, S, H*P + 2*G*N) tensor, as ``mamba2_fwd`` cuts them from
    its conv output (sequence stride H*P + 2*G*N, B and C at an offset
    inside each row)."""
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=gen) \
        .to("cuda", dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    A = -torch.exp(torch.rand((H,), generator=gen))
    if strong:
        A = torch.full((H,), -16.0)
        dt = 4.0 * dt + 4.0
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                 Cm.reshape(B, S, G, N))
    if not views:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    return x, dt.cuda(), A.cuda(), Bm, Cm


def _ssm_work(B, S, H, P, N, Lc) -> float:
    """Operations the SSD scan needs: per (batch, head) and chunk the
    causal pairs' C.B and W.x products, the chunk state, the carried
    state's C.h for every chunk after the first, and the scan's update."""
    nc = S // Lc
    pairs = Lc * (Lc + 1) // 2
    per_bh = (nc * (2 * pairs * (N + P) + 2 * Lc * P * N + 2 * P * N)
              + (nc - 1) * 2 * Lc * P * N)
    return float(B * H * per_bh)


def phase_ssm_scan(ptxas: dict) -> dict:
    """The SSD chunked-scan kernel against its plain version (fp32 y and
    state from bf16 inputs on the tensor cores or fp32 inputs on the
    CUDA cores, no NaN), with the share of the tolerance each case uses,
    both timed and the kernel's achieved TFLOP/s (``_ssm_work`` over its
    time); no single PyTorch call computes the scan, so there is no
    library time.  Also prints what ptxas reported for the bf16
    kernels."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as K
    gen = torch.Generator().manual_seed(4)
    atol, rtol = SSM_TOL
    rows, main = [], None
    for B, S, H, P, N, G, chunk, strong, views in SSM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            args = _ssm_case(B, S, H, P, N, G, strong, views, dtype, gen)
            y, h = K.ssm_chunk_scan_kernel(*args, chunk=chunk)
            wy, wh = ref.ssm_chunk_scan_ref(*args, chunk)
            torch.cuda.synchronize()
            check(y.dtype == h.dtype == torch.float32, "ssm: output not fp32")
            check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                  f"ssm {B,S,H,P,N} strong={strong}: non-finite output")
            err_y, ex_y = _max_excess(y, wy, atol, rtol)
            err_h, ex_h = _max_excess(h, wh, atol, rtol)
            check(max(ex_y, ex_h) <= 0, f"ssm {B,S,H,P,N,G} chunk {chunk} "
                  f"strong={strong} views={views} {dtype}: max_abs_err y "
                  f"{err_y} h {err_h} over atol {atol} + rtol {rtol}")
            x, dt, A, Bm, Cm = args
            item = x.element_size()
            n_bytes = (item * (x.numel() + Bm.numel() + Cm.numel())
                       + 4 * (dt.numel() + A.numel() + y.numel() + h.numel()))
            peak = (BF16_FLOP_PER_S if dtype == torch.bfloat16
                    else FP32_FLOP_PER_S)
            work = _ssm_work(B, S, H, P, N, min(chunk, S))
            b_ms, b_by = bound_ms(n_bytes, work, peak)
            ms = time_ms(lambda: K.ssm_chunk_scan_kernel(*args, chunk=chunk))
            row = dict(shape=[B, S, H, P, N], groups=G, chunk=chunk,
                       strong_decay=strong, xbc_views=views,
                       x_strides=list(x.stride()), dtype=str(dtype)[6:],
                       max_abs_err=max(err_y, err_h), max_abs_err_y=err_y,
                       max_abs_err_state=err_h, atol=atol, rtol=rtol,
                       max_abs_y=float(wy.abs().max()),
                       share_of_tolerance=max(
                           _share_of_tolerance(y, wy, atol, rtol),
                           _share_of_tolerance(h, wh, atol, rtol)),
                       ms=ms, tflop_per_s=work / ms / 1e9,
                       plain_ms=time_ms(lambda: ref.ssm_chunk_scan_ref(
                           *args, chunk), iters=10),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       bound_peak_flop_per_s=peak)
            rows.append(row)
            if (B, S, H, P, N, G, chunk, strong, views) == SSM_SHAPES[0] \
                    and dtype == torch.bfloat16:
                row["device_us_by_kernel"] = profile_device(
                    lambda: K.ssm_chunk_scan_kernel(*args, chunk=chunk))[0]
                main = row
    emit("ssm_chunk_scan", cases=rows,
         ptxas_bf16=[f for f in ptxas.get("ssm_chunk_scan", [])
                     if "tc_kernel" in f["function"]])
    return main


def _requests(n, lo, hi, max_new, vocab, seed):
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new=max_new, arrival_t=0.5 * i)
            for i in range(n)]


def _request(prompt, max_new):
    from repro_torch.serving.batching import Request
    return Request(prompt=np.asarray(prompt, np.int32), max_new=max_new)


def _next_logits(params, cfg, tokens: np.ndarray) -> torch.Tensor:
    """Next-token logits after ``tokens``, from one monolithic prefill
    chunk on a fresh pool (hybrid: one forward pass), on the params'
    device."""
    from repro_torch.models import transformer as T
    dev = params["embed"].device
    if cfg.family == "hybrid":
        toks = torch.from_numpy(tokens.astype(np.int32))[None].to(dev)
        return T.forward(params, cfg, {"tokens": toks})[0][0, -1]
    n_pages = -(-len(tokens) // PAGE)
    pool = T.init_paged_cache(cfg, n_pages + 1, PAGE, device=dev)
    bt = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.from_numpy(tokens.astype(np.int32))[None].to(dev)
    logits, _, _ = T.prefill_chunk(params, cfg, pool, toks, len(tokens), 0,
                                   bt)
    return logits[0, -1]


def _serve_tokens(cfg, params, reqs, max_seq=256, **kw) -> list:
    """Each request's greedy tokens, in request order, from a
    ContinuousEngine on the params' device."""
    from repro_torch.serving.engine import ContinuousEngine
    clones = [r.clone() for r in reqs]
    res = ContinuousEngine(cfg, params, n_slots=4, max_seq=max_seq,
                           **kw).run(clones)
    return [res[r.rid].tokens for r in clones]


def _near_ties(name, runs, want, prompts, cpu_params, cfg) -> tuple:
    """Compare each run with the reference run ``want``: a sequence may
    differ only from a position where the reference's top-2 logits lie
    within NEAR_TIE of each other.  Returns (near-ties, divergences)."""
    n, diffs = 0, []
    for i, (a, b) in enumerate(zip(runs, want)):
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a[:len(b)] != b[:len(a)]))
        prefix = np.concatenate([prompts[i], b[:j]])
        top2 = torch.topk(_next_logits(cpu_params, cfg, prefix), 2).values
        gap = float(top2[0] - top2[1])
        diffs.append(dict(run=name, request=i, position=j, top2_gap=gap))
        check(gap < NEAR_TIE, f"cross-check {name}: request {i} diverges "
              f"at {j} with a top-2 gap of {gap} (not a near-tie)")
        n += 1
    return n, diffs


def phase_cross_check(device: str = "cuda") -> None:
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("smollm-360m").with_(
        n_layers=4, param_dtype="float32", activation_dtype="float32")
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    cuda_params = _to(cpu_params, device)
    reqs = _requests(6, 16, 96, 8, cfg.vocab_size, seed=5)
    prompts = [r.prompt for r in reqs]
    want = _serve_tokens(cfg, cpu_params, reqs)               # paged, cpu
    runs = {"paged_cuda": _serve_tokens(cfg, cuda_params, reqs),
            "contiguous_cuda": _serve_tokens(cfg, cuda_params, reqs,
                                             kv_layout="contiguous")}
    # a same-length batch: ServingEngine on cuda and cpu, and the paged
    # engine on cuda, against ServingEngine on cpu
    batch = np.random.default_rng(6).integers(
        1, cfg.vocab_size, (4, 48)).astype(np.int32)
    fixed_cpu = list(ServingEngine(cfg, cpu_params, max_seq=256).generate(
        batch, max_new=8).tokens)
    fixed_runs = {
        "fixed_cuda": list(ServingEngine(cfg, cuda_params, max_seq=256)
                           .generate(batch, max_new=8).tokens),
        "fixed_batch_paged_cuda": _serve_tokens(
            cfg, cuda_params, [_request(p, 8) for p in batch])}
    near, diffs = 0, []
    for name, run in runs.items():
        n, d = _near_ties(name, run, want, prompts, cpu_params, cfg)
        near, diffs = near + n, diffs + d
    for name, run in fixed_runs.items():
        n, d = _near_ties(name, run, fixed_cpu, list(batch), cpu_params, cfg)
        near, diffs = near + n, diffs + d
    n_seq = len(reqs) * len(runs) + len(batch) * len(fixed_runs)
    emit("cross_check", n_layers=cfg.n_layers,
         runs=["paged_cpu (reference)", *runs, "fixed_cpu (reference)",
               *fixed_runs],
         n_sequences_compared=n_seq, identical=n_seq - near, near_ties=near,
         divergences=diffs, tf32=False)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _cloned(x):
    """x with every tensor in it (a tuple, a dict or a tensor) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


class _StepTimes:
    """CUDA events around every ``transformer.prefill`` and
    ``transformer.decode_step`` call made while it is active (the engines
    call them through the module), and the bytes of the cache the first
    decode step is given: a serve phase's prefill time, time per decode
    step and cache size, read from its own run.  Read after a sync.
    With ``capture_at``, the arguments of that decode step (0-based)
    are kept for ``_decode_checks``: the live cache, clones of the rest
    (a dense decode step run again on them writes the same K/V rows and
    reads the same positions)."""

    def __init__(self, capture_at: int = None):
        self.capture_at = capture_at
        self.captured = None

    def __enter__(self):
        from repro_torch.models import transformer as T
        self._T, self._orig = T, (T.prefill, T.decode_step)
        self.events = {"prefill": [], "decode": []}
        self.cache_bytes = None

        def timed(fn, which):
            def call(*a, **kw):
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                out = fn(*a, **kw)
                e.record()
                self.events[which].append((s, e))
                return out
            return call

        decode = timed(T.decode_step, "decode")

        def decode_step(params, cfg, cache, *a, **kw):
            if self.cache_bytes is None:
                self.cache_bytes = _tree_bytes(cache)
            if len(self.events["decode"]) == self.capture_at:
                self.captured = (params, cfg, cache, _cloned(a),
                                 _cloned(kw))
            return decode(params, cfg, cache, *a, **kw)

        T.prefill, T.decode_step = timed(T.prefill, "prefill"), decode_step
        return self

    def __exit__(self, *exc):
        self._T.prefill, self._T.decode_step = self._orig

    def seconds(self, which: str) -> list:
        return [s.elapsed_time(e) / 1e3 for s, e in self.events[which]]


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
    with _StepTimes(capture_at=CAPTURE_STEP) as steps:
        results = eng.run(reqs)
        decisions = {rid: gate.decide(torch.from_numpy(r.logits_last[None])
                                      .to(device))
                     for rid, r in results.items()}
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
    decode_s = steps.seconds("decode")
    side = _decode_checks(steps, cfg.n_layers, profile=True)
    emit("full_serve", arch=cfg.name, n_layers=cfg.n_layers,
         n_requests=len(reqs), ticks=eng.clock,
         decode_steps=eng.decode_steps_total,
         prefill_tokens=eng.prefill_tokens_total, generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, launches=counts,
         decode_s_per_step=sum(decode_s) / len(decode_s),
         escalated=escalated, peak_mem_bytes=peak,
         kv=eng.kv_cache_stats(), decode_step=side)
    _check_held(side, "full serve decode step")
    return counts, [results[r.rid].tokens for r in reqs]


def _top2_gaps(logits: np.ndarray) -> list:
    """Each row's gap between its two largest logits: how near the
    greedy token was to a tie."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]).tolist()


def phase_fixed_serve(device: str = "cuda") -> dict:
    """smollm-360m at full width and depth in bf16: one batch of 8
    prompts of 1024 tokens, 32 new tokens each, through
    ServingEngine.generate; the gate decides the batch's final logits.
    Then ``_prefill_checks`` on the same prompts.  Returns the launch
    counts."""
    from repro_torch.config import get_config
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("smollm-360m")
    B, S, max_new = 8, 1024, 32
    eng = ServingEngine.init(cfg, seed=0, max_seq=2048, device=device)
    prompts = np.random.default_rng(8).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    gate = ConfidenceGate()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _StepTimes(capture_at=CAPTURE_STEP) as steps:
        res = eng.generate(prompts, max_new=max_new)
        dec = gate.decide(torch.from_numpy(res.logits_last).to(device))
        escalated = int(dec["escalate"].sum())
        sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(res.tokens.shape == (B, max_new)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "fixed serve: bad tokens")
    for logits in (res.logits_last, res.prompt_logits):
        check(logits.shape == (B, cfg.vocab_size)
              and bool(np.isfinite(logits).all()),
              "fixed serve: non-finite logits")
    check(counts["flash_attention"] == cfg.n_layers,
          f"flash launches {counts['flash_attention']} != {cfg.n_layers} "
          "layers x 1 prefill")
    check(counts["decode_attention"] == cfg.n_layers * max_new,
          f"decode launches {counts['decode_attention']} != "
          f"{cfg.n_layers} x {max_new} decode steps")
    check(counts["confidence_gate"] == 1, "gate launches")
    peak = torch.cuda.max_memory_allocated()
    decode_s = steps.seconds("decode")
    side = _prefill_checks(eng.params, cfg, prompts, "fixed serve")
    step = _decode_checks(steps, cfg.n_layers, profile=True)
    emit("fixed_serve", arch=cfg.name, n_layers=cfg.n_layers, batch=B,
         prompt_len=S, max_new=max_new, generated_tokens=B * max_new,
         wall_s=wall, tokens_per_s=B * max_new / wall, launches=counts,
         prefill_s=sum(steps.seconds("prefill")),
         decode_s_per_step=sum(decode_s) / len(decode_s),
         escalated=escalated, peak_mem_bytes=peak,
         kv_cache_bytes=steps.cache_bytes, **side, decode_step=step,
         first_token_top2_gap=_top2_gaps(res.prompt_logits),
         tokens=res.tokens.tolist())
    _check_held(side, "fixed serve")
    _check_held(step, "fixed serve decode step")
    return counts


def phase_contiguous_serve(paged_tokens, device: str = "cuda") -> dict:
    """full_serve's 16 requests through the contiguous ContinuousEngine
    (8 slots, max_seq 2048): one flash prefill per admission and one
    contiguous decode per layer and decode step."""
    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousEngine
    cfg = get_config("smollm-360m")
    eng = ContinuousEngine.init(cfg, seed=0, device=device, n_slots=8,
                                max_seq=2048, kv_layout="contiguous")
    reqs = _requests(16, 64, 512, 32, cfg.vocab_size, seed=7)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    tokens = [results[r.rid].tokens for r in reqs]
    check(len(results) == len(reqs), "contiguous serve: requests lost")
    for r in results.values():
        check(len(r.tokens) == 32
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all()),
              "contiguous serve: bad tokens")
        check(bool(np.isfinite(r.logits_last).all()),
              "contiguous serve: non-finite final logits")
    check(counts["flash_attention"] == cfg.n_layers * len(reqs),
          f"flash launches {counts['flash_attention']} != {cfg.n_layers} "
          f"x {len(reqs)} admissions")
    check(counts["decode_attention"] == cfg.n_layers * eng.decode_steps_total,
          f"decode launches {counts['decode_attention']} != "
          f"{cfg.n_layers} x {eng.decode_steps_total} decode steps")
    same = sum(np.array_equal(a, b) for a, b in zip(tokens, paged_tokens))
    n_tok = sum(len(t) for t in tokens)
    emit("contiguous_serve", arch=cfg.name, n_layers=cfg.n_layers,
         n_requests=len(reqs), ticks=eng.clock,
         decode_steps=eng.decode_steps_total, generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, launches=counts,
         same_tokens_as_paged=same,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         kv=eng.kv_cache_stats())
    return counts


def phase_hybrid_cross_check(device: str = "cuda") -> None:
    """zamba2-7b widths at 7 layers in fp32 with TF32 off: the fixed-slot
    and the continuous engine on cuda against the same engines on cpu.
    Prompts of 512 tokens (two chunks of 256, so the state carried
    across chunks reaches the tokens) and of 40 and 100 (one chunk
    shorter than 256)."""
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("zamba2-7b").with_(
        n_layers=7, param_dtype="float32", activation_dtype="float32")
    cuda_params = T.init_params(cfg, seed=0, device=device)
    cpu_params = _to(cuda_params, "cpu")
    rng = np.random.default_rng(11)
    max_seq = 640
    batch = rng.integers(1, cfg.vocab_size, (2, 512)).astype(np.int32)
    fixed_cpu, fixed_cuda = (
        list(ServingEngine(cfg, p, max_seq=max_seq).generate(
            batch, max_new=6).tokens)
        for p in (cpu_params, cuda_params))
    reqs = [_request(rng.integers(1, cfg.vocab_size, n), 6)
            for n in (40, 100, 512)]
    cont_cpu = _serve_tokens(cfg, cpu_params, reqs, max_seq=max_seq)
    cont_cuda = _serve_tokens(cfg, cuda_params, reqs, max_seq=max_seq)
    n1, d1 = _near_ties("hybrid_fixed_cuda", fixed_cuda, fixed_cpu,
                        list(batch), cpu_params, cfg)
    n2, d2 = _near_ties("hybrid_continuous_cuda", cont_cuda, cont_cpu,
                        [r.prompt for r in reqs], cpu_params, cfg)
    n_seq = len(batch) + len(reqs)
    emit("hybrid_cross_check", arch=cfg.name, n_layers=cfg.n_layers,
         prompt_lens={"fixed": [batch.shape[1]] * len(batch),
                      "continuous": [len(r.prompt) for r in reqs]},
         chunk=cfg.ssm.chunk, runs=["fixed_cpu (reference)", "hybrid_fixed_cuda",
               "continuous_cpu (reference)", "hybrid_continuous_cuda"],
         n_sequences_compared=n_seq, identical=n_seq - n1 - n2,
         near_ties=n1 + n2, divergences=d1 + d2, tf32=False)


def _hybrid_counts(counts, cfg, prefills, decode_steps, gated, what):
    """zamba2's launches: one SSD scan per Mamba2 block and one flash per
    shared-attention application per prefill, one decode per application
    per decode step, one gate per gated result."""
    units = cfg.n_layers // cfg.shared_attn_every
    want = {"ssm_chunk_scan": cfg.n_layers * prefills,
            "flash_attention": units * prefills,
            "decode_attention": units * decode_steps,
            "confidence_gate": gated, "paged_decode_attention": 0,
            "int8_quantize": 0}
    check(counts == want, f"{what}: launches {counts} != {want}")


def phase_hybrid_fixed_serve(cfg, params, device: str = "cuda") -> dict:
    """zamba2-7b uncut in bf16: one batch of 4 prompts of 512 tokens, 32
    new tokens each, through ServingEngine.generate; the gate decides
    the batch's final logits.  Then ``_prefill_checks`` on the same
    prompts.  Returns the launch counts."""
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    B, S, max_new = 4, 512, 32
    eng = ServingEngine(cfg, params, max_seq=1024)
    prompts = np.random.default_rng(9).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    gate = ConfidenceGate()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _StepTimes(capture_at=CAPTURE_STEP) as steps:
        res = eng.generate(prompts, max_new=max_new)
        dec = gate.decide(torch.from_numpy(res.logits_last).to(device))
        escalated = int(dec["escalate"].sum())
        sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(res.tokens.shape == (B, max_new)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "hybrid fixed serve: bad tokens")
    for logits in (res.logits_last, res.prompt_logits):
        check(logits.shape == (B, cfg.vocab_size)
              and bool(np.isfinite(logits).all()),
              "hybrid fixed serve: non-finite logits")
    _hybrid_counts(counts, cfg, 1, max_new, 1, "hybrid fixed serve")
    decode_s = steps.seconds("decode")
    side = _prefill_checks(params, cfg, prompts, "hybrid fixed serve")
    step = _decode_checks(steps, cfg.n_layers // cfg.shared_attn_every,
                          profile=False)
    emit("hybrid_fixed_serve", arch=cfg.name, n_layers=cfg.n_layers,
         batch=B, prompt_len=S, max_new=max_new,
         generated_tokens=B * max_new, wall_s=wall,
         tokens_per_s=B * max_new / wall, launches=counts,
         prefill_s=sum(steps.seconds("prefill")),
         decode_s_per_step=sum(decode_s) / len(decode_s),
         escalated=escalated, peak_mem_bytes=peak,
         cache_bytes=steps.cache_bytes, **side, decode_step=step,
         first_token_top2_gap=_top2_gaps(res.prompt_logits),
         tokens=res.tokens.tolist())
    _check_held(side, "hybrid fixed serve")
    _check_held(step, "hybrid fixed serve decode step")
    return counts


def phase_hybrid_continuous_serve(cfg, params, device: str = "cuda") -> dict:
    """The same weights: 8 requests with prompts of 64 to 768 tokens (all
    lengths the reference admits at chunk 256) and 16 to 32 new tokens
    through ContinuousEngine (4 slots, max_seq 1024, the contiguous
    SlotManager); every result gated."""
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.batching import Request
    from repro_torch.serving.engine import ContinuousEngine
    rng = np.random.default_rng(10)
    lens = (768, 64, 512, 200, 128, 256, 64, 512)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32), max_new=int(rng.integers(16, 33)),
                    arrival_t=0.5 * i) for i, n in enumerate(lens)]
    eng = ContinuousEngine(cfg, params, n_slots=4, max_seq=1024)
    check(eng.kv_layout == "contiguous", "hybrid: not the contiguous layout")
    gate = ConfidenceGate()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(reqs)
    decisions = [gate.decide(torch.from_numpy(r.logits_last[None]).to(device))
                 for r in results.values()]
    escalated = sum(bool(d["escalate"][0]) for d in decisions)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(len(results) == len(reqs), "hybrid continuous serve: lost requests")
    for r in reqs:
        got = results[r.rid]
        check(len(got.tokens) == r.max_new and bool(
            ((got.tokens >= 0) & (got.tokens < cfg.vocab_size)).all()),
              "hybrid continuous serve: bad tokens")
        check(bool(np.isfinite(got.logits_last).all()),
              "hybrid continuous serve: non-finite final logits")
    _hybrid_counts(counts, cfg, len(reqs), eng.decode_steps_total,
                   len(reqs), "hybrid continuous serve")
    n_tok = sum(len(r.tokens) for r in results.values())
    emit("hybrid_continuous_serve", arch=cfg.name, n_layers=cfg.n_layers,
         n_requests=len(reqs), prompt_lens=list(lens),
         max_new=[r.max_new for r in reqs], ticks=eng.clock,
         decode_steps=eng.decode_steps_total, generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, launches=counts,
         escalated=escalated, peak_mem_bytes=torch.cuda.max_memory_allocated(),
         kv=eng.kv_cache_stats())
    return counts


# --------------------------------------------------------------------------
# the EO case study
# --------------------------------------------------------------------------

def _classifier(params, cfg):
    from repro_torch.core import classifier as CL
    return lambda batch: CL.apply_classifier(params, cfg, batch)


def _engine(tiers, thr, device, **kw):
    """The cascade over the (onboard, ground) tile-classifier params, with
    a max_prob gate at ``thr`` and fp32 tiles (4 bytes an element)."""
    from repro_torch.core import classifier as CL
    from repro_torch.core.cascade import CascadeConfig, CollaborativeEngine
    from repro_torch.core.gating import ConfidenceGate
    return CollaborativeEngine(
        _classifier(tiers[0], CL.ONBOARD), _classifier(tiers[1], CL.GROUND),
        CascadeConfig(gate=ConfidenceGate("max_prob", thr), item_dtype_bytes=4,
                      **kw), device=device)


def _calibrate(onboard, x, budget) -> float:
    """The gate's threshold for an escalation budget on ``x``, as the
    reference benchmarks calibrate it (a probe gate at 1.1)."""
    from repro_torch.core import classifier as CL
    from repro_torch.core.gating import ConfidenceGate, calibrate_threshold
    probe = ConfidenceGate("max_prob", 1.1).decide(
        CL.apply_classifier(onboard, CL.ONBOARD, x))["confidence"]
    probe = probe.cpu().numpy()
    return calibrate_threshold(probe, np.ones_like(probe, bool), budget)


def _train_tiers(cfg_kw, n, steps, device) -> tuple:
    from repro_torch.core import classifier as CL
    from repro_torch.data import eo
    tiles, labels, _ = eo.make_tiles(n, eo.EOConfig(**cfg_kw))
    return tuple(CL.train_classifier(c, tiles, labels, steps=k,
                                     device=device)[0]
                 for c, k in zip((CL.ONBOARD, CL.GROUND), steps))


def phase_eo_figures(device: str = "cuda") -> dict:
    """The paper's Figures 6 and 7 and its data reduction, on the card at
    the reference benchmarks' sizes and seeds, with tiers trained in
    torch; each figure beside the JAX package's result and the paper's.
    Returns data_reduction's trained tiers and calibrated threshold."""
    from repro_torch.core.filtering import filter_tiles
    from repro_torch.data import eo
    t0 = time.perf_counter()
    fig6 = {}
    for name, cfg in (("v1", eo.V1), ("v2", eo.V2)):
        tiles = torch.from_numpy(eo.make_tiles(600, cfg)[0])
        keep, st = filter_tiles(tiles.to(device))
        keep_cpu, st_cpu = filter_tiles(tiles)
        check(torch.equal(keep.cpu(), keep_cpu),
              f"fig6 {name}: the card's filter mask differs from the cpu's")
        rate, rate_cpu = float(st["filter_rate"]), float(st_cpu["filter_rate"])
        check(abs(rate - rate_cpu) <= 1e-7, f"fig6 {name}: filter rate "
              f"{rate} on the card, {rate_cpu} on the cpu")
        fig6[name] = dict(filter_rate=rate, filter_rate_cpu=rate_cpu,
                          reference=REFERENCE["fig6_filter_rate"][name],
                          paper=PAPER["fig6_filter_rate"][name])
    fig7 = {}
    for name, kw in FIG7_REGIMES.items():
        tiers = _train_tiers(kw, 2500, (350, 700), device)
        te_t, te_l, _ = eo.make_tiles(
            500, eo.EOConfig(**{**kw, "seed": kw["seed"] + 100}))
        keep = te_l >= 0
        x = torch.from_numpy(te_t[keep]).to(device)
        labels = te_l[keep]
        thr = _calibrate(tiers[0], x, FIG7_BUDGET[name])
        eng = _engine(tiers, thr, device)
        collab = eng.run(x, item_shape=x.shape[1:])
        inorbit = eng.run(x, item_shape=x.shape[1:], ground_available=False)
        acc_c = float(np.mean(collab.predictions == labels))
        acc_o = float(np.mean(inorbit.predictions == labels))
        esc = collab.ledger.summary()["escalation_rate"]
        check(acc_c > acc_o, f"fig7 {name}: collaborative accuracy {acc_c} "
              f"not above in-orbit {acc_o}")
        check(esc <= FIG7_BUDGET[name] + 1 / len(labels),
              f"fig7 {name}: escalation rate {esc} over its budget")
        fig7[name] = dict(acc_inorbit=acc_o, acc_collaborative=acc_c,
                          relative_gain=(acc_c - acc_o) / max(acc_o, 1e-9),
                          escalation_rate=esc, threshold=thr,
                          n_test=len(labels),
                          reference=REFERENCE["fig7"][name],
                          paper_relative_gain=PAPER["fig7_relative_gain"][name])
    # data_reduction: the filter's survivors and the budget fix the bytes
    tiers = _train_tiers(DR_TRAIN, 1500, (250, 400), device)
    tiles = eo.make_tiles(500, eo.V1)[0]
    x = torch.from_numpy(tiles).to(device)
    keep, fstats = filter_tiles(x)
    surv = x[keep]
    thr = _calibrate(tiers[0], surv, DR_BUDGET)
    runs = {q: _engine(tiers, thr, device, quantize_payload=q).run(
        surv, item_shape=surv.shape[1:]) for q in (False, True)}
    for q, res in runs.items():
        got = res.ledger.get("bytes_downlinked")
        check(got == DR_BYTES[q], f"data_reduction (quantize_payload={q}): "
              f"{got} bytes downlinked, not {DR_BYTES[q]}")
    check(np.array_equal(runs[True].escalated, runs[False].escalated)
          and np.array_equal(runs[True].predictions, runs[False].predictions),
          "data_reduction: the quantized run routes otherwise than the plain")
    s = runs[False].ledger.summary()
    dr = dict(bytes_bent_pipe=int(tiles.nbytes),
              bytes_downlinked=int(s["bytes_downlinked"]),
              bytes_downlinked_int8=int(runs[True].ledger.get(
                  "bytes_downlinked")),
              reduction=1.0 - s["bytes_downlinked"] / tiles.nbytes,
              reduction_int8=1.0 - runs[True].ledger.get("bytes_downlinked")
              / tiles.nbytes,
              filter_rate=float(fstats["filter_rate"]), survivors=len(surv),
              escalation_rate=s["escalation_rate"], threshold=thr,
              reference=REFERENCE["data_reduction"],
              paper=PAPER["data_reduction"])
    emit("eo_figures", fig6_filter_rate=fig6, fig7_accuracy=fig7,
         data_reduction=dr, seconds=time.perf_counter() - t0)
    return {"tiers": tiers, "threshold": thr}


def _decider_gap(logits: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1]


def phase_eo_cross_check(tiers, thr, device: str = "cuda") -> None:
    """data_reduction's trained tiers run the EO pipeline (filter, onboard
    tier, gate, int8 payload, ground tier) on 600 V1 tiles on the card
    and on the cpu, in fp32 with TF32 off: identical filter masks,
    escalations, ledgers and int8 payloads; identical predictions apart
    from counted near-ties of the deciding tier's top-2 logits."""
    from repro_torch.core import classifier as CL
    from repro_torch.core.filtering import filter_tiles
    from repro_torch.data import eo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiles = torch.from_numpy(eo.make_tiles(600, eo.V1)[0])
    cpu_tiers = tuple(_to(p, "cpu") for p in tiers)
    out = {}
    for dev, dev_tiers in ((device, tiers), ("cpu", cpu_tiers)):
        x = tiles.to(dev)
        keep, _ = filter_tiles(x)
        surv = x[keep]
        res = _engine(dev_tiers, thr, dev, quantize_payload=True).run(
            surv, item_shape=surv.shape[1:])
        out[dev] = (keep.cpu(), res, surv.cpu())
    (keep, got, _), (keep_cpu, want, surv) = out[device], out["cpu"]
    check(torch.equal(keep, keep_cpu), "eo_cross_check: filter masks differ")
    check(np.array_equal(got.escalated, want.escalated),
          "eo_cross_check: escalations differ")
    check(got.ledger.counters == want.ledger.counters,
          f"eo_cross_check: ledgers differ {got.ledger.counters} "
          f"{want.ledger.counters}")
    if want.payload is not None:
        check(torch.equal(got.payload[0].cpu(), want.payload[0])
              and torch.equal(got.payload[1].cpu(), want.payload[1]),
              "eo_cross_check: the int8 payloads differ")
    diff = np.nonzero(got.predictions != want.predictions)[0]
    divergences = []
    if len(diff):
        # the deciding tier's logits on the cpu, at the differing items
        gap = torch.where(
            torch.from_numpy(want.escalated[diff]),
            _decider_gap(CL.apply_classifier(cpu_tiers[1], CL.GROUND,
                                             surv[diff])),
            _decider_gap(CL.apply_classifier(cpu_tiers[0], CL.ONBOARD,
                                             surv[diff])))
        for i, g in zip(diff.tolist(), gap.tolist()):
            divergences.append(dict(item=i, top2_gap=g))
            check(g < NEAR_TIE, f"eo_cross_check: item {i} predicted "
                  f"otherwise with a top-2 gap of {g} (not a near-tie)")
    emit("eo_cross_check", n_tiles=len(keep), survivors=int(keep.sum()),
         escalated=int(want.escalated.sum()),
         identical_predictions=len(want.predictions) - len(diff),
         near_ties=len(diff), divergences=divergences,
         max_confidence_diff=float(np.abs(got.confidence
                                          - want.confidence).max()),
         ledger=want.ledger.counters, tf32=False)


class _StageTimes:
    """CUDA events around every call of each wrapped callable: a stage's
    device time, summed over the run.  Read after a sync."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            self.events.setdefault(name, []).append((s, e))
            return out
        return call

    def ms(self) -> dict:
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}


def phase_eo_scene(tiers, thr, frames_n=SCENE_FRAMES, frame=SCENE_FRAME,
                   per_pass=SCENE_PASS, device: str = "cuda") -> tuple:
    """One scene at realistic size through the EO pipeline: V1 tiles
    merged on the host into frames, moved to the card, then each pass of
    ``per_pass`` frames goes split_batch -> filter_tiles -> onboard tier
    -> gate -> int8 payload -> ground tier (quantize_payload, the
    data_reduction tiers).  Returns the launch counts and the largest
    pass's escalated rows, the int8 kernel's main-path input."""
    from repro_torch.core import classifier as CL
    from repro_torch.core.filtering import filter_tiles
    from repro_torch.core.tiling import merge_tiles, split_batch
    from repro_torch.data import eo
    from repro_torch.kernels import ops, ref
    per_frame = (frame // EO_TILE) ** 2
    n_tiles = frames_n * per_frame
    t0 = time.perf_counter()
    tiles, labels, _ = eo.make_tiles(n_tiles, eo.V1)
    gen_s = time.perf_counter() - t0
    host = torch.from_numpy(tiles)
    frames = torch.stack([merge_tiles(host[f * per_frame:(f + 1) * per_frame],
                                      frame, frame)
                          for f in range(frames_n)]).to(device)
    item_shape = (EO_TILE, EO_TILE, 3)
    st = _StageTimes()
    eng = _engine(tiers, thr, device, quantize_payload=True)
    eng.onboard_fn = st.wrap("onboard_tier", eng.onboard_fn)
    eng.ground_fn = st.wrap("ground_tier", eng.ground_fn)
    split = st.wrap("split", lambda f: split_batch(f, EO_TILE))
    filt = st.wrap("filter", filter_tiles)
    run = st.wrap("cascade", eng.run)
    orig = ops.confidence_gate, ops.int8_quantize
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    passes = []
    t0 = time.perf_counter()
    try:
        ops.confidence_gate = st.wrap("gate", orig[0])
        ops.int8_quantize = st.wrap("int8_payload", orig[1])
        for p0 in range(0, frames_n, per_pass):
            t = split(frames[p0:p0 + per_pass])
            keep, _ = filt(t)
            surv = t[keep]
            passes.append((t, keep, surv, run(surv, item_shape)))
        sync()
    finally:
        ops.confidence_gate, ops.int8_quantize = orig
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # checks, outside the timed run
    n_gated = sum(len(s) > 0 for _, _, s, _ in passes)
    n_esc_passes = sum(bool(r.escalated.any()) for *_, r in passes)
    want = {**{k: 0 for k in counts}, "confidence_gate": n_gated,
            "int8_quantize": n_esc_passes}
    check(counts == want, f"eo_scene: launches {counts} != {want}")
    totals, correct, labelled, biggest = {}, 0, 0, None
    eps = torch.finfo(torch.float32).eps
    onboard = _classifier(tiers[0], CL.ONBOARD)
    gate_used = 0.0
    for i, (t, keep, surv, res) in enumerate(passes):
        lo = i * per_pass * per_frame
        check(torch.equal(t, host[lo:lo + len(t)].to(device)),
              f"eo_scene: split_batch of pass {i} is not the scene's tiles")
        # the gate at this pass's shape, (survivors, 8), against the
        # plain version; the cascade's confidences are the kernel's
        logits = onboard(surv).float()
        got = ops.confidence_gate(logits)
        _, used = _check_gate(got, ref.confidence_gate_ref(logits),
                              f"eo_scene: pass {i}: gate {tuple(logits.shape)}")
        gate_used = max(gate_used, used)
        check(np.allclose(res.confidence, got["max_prob"].cpu().numpy(),
                          rtol=0, atol=1e-6),
              f"eo_scene: pass {i}: these logits are not the ones the "
              f"cascade gated")
        for k, v in res.ledger.counters.items():
            totals[k] = totals.get(k, 0.0) + v
        lab = labels[lo:lo + len(t)][keep.cpu().numpy()]
        check(bool(((res.predictions >= 0) & (res.predictions < 8)).all()),
              "eo_scene: prediction out of range")
        correct += int((res.predictions == lab)[lab >= 0].sum())
        labelled += int((lab >= 0).sum())
        if res.payload is None:
            continue
        q, s = res.payload
        rows = surv[torch.from_numpy(res.escalated).to(device)] \
            .reshape(len(q), -1)
        err = (q.float() * s[:, None] - rows).abs()
        check(bool((err <= s[:, None] / 2 + eps * rows.abs()).all()),
              f"eo_scene: pass {i}: dequantization error over half a step")
        check(q.numel() + 4 * s.numel()
              == res.ledger.get("bytes_raw_escalated"),
              f"eo_scene: pass {i}: ledger bytes != the payload's")
        if biggest is None or len(rows) > len(biggest):
            biggest = rows
    scene_bytes = n_tiles * EO_TILE * EO_TILE * 3 * 4
    emit("eo_scene", n_tiles=n_tiles, frames=frames_n, frame=[frame, frame],
         passes=len(passes), tiles_per_pass=per_pass * per_frame,
         scene_bytes_on_device=frames.numel() * frames.element_size(),
         tile_generation_s=gen_s, wall_s=wall, tiles_per_s=n_tiles / wall,
         stage_ms=st.ms(), launches=counts,
         gate_share_of_tolerance=gate_used,
         survivors=[len(s) for _, _, s, _ in passes],
         escalated=[int(r.escalated.sum()) for *_, r in passes],
         bytes_downlinked=totals["bytes_downlinked"],
         bytes_bent_pipe=scene_bytes,
         reduction=1.0 - totals["bytes_downlinked"] / scene_bytes,
         ledger=totals, accuracy_on_labelled_survivors=correct / max(
             labelled, 1), peak_mem_bytes=peak)
    return counts, biggest


def phase_int8(eo_rows=None, device: str = "cuda") -> dict:
    """The int8 kernel against its plain version: q bit for bit, the
    scale within rtol 1e-6, dequantization error at most half a step
    (plus an ulp of |x|); at eo_scene's largest escalated payload (its
    main-path input; without one, tests/torch_inputs.py's rows at that
    payload's shape, EO_PAYLOAD, so the phase runs on its own), the
    reference test's shapes in fp32 and bf16, odd shapes, one odd width
    that takes the kernel's scalar path, and planted .5 ties with a zero
    row.  The inputs are tests/torch_inputs.py's, as in
    tests/test_torch_cuda.py.  Each case reports the kernel's plan.  Bound
    by bytes: N x D x (itemsize + 1) + 4N; no single PyTorch call
    computes the absmax quantization (quantize_per_channel takes its
    scales as input)."""
    TI = _torch_inputs()
    from repro_torch.kernels import int8_quant as K
    from repro_torch.kernels import ref

    def rows_(N, D, dtype=torch.float32):
        x = torch.from_numpy(TI.int8_inputs(N, D, seed=N + D))
        return x.to(device, dtype)

    if eo_rows is None:
        eo_rows = rows_(*EO_PAYLOAD)
    cases = [("eo_payload", eo_rows)]
    for N, D in TI.INT8_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("reference_test", rows_(N, D, dtype)))
    for N, D in TI.INT8_ODD:
        cases.append(("odd", rows_(N, D)))
    cases.append(("scalar_path", rows_(*TI.INT8_ODD[0])[:, 1:].contiguous()))
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(("ties", rows_(64, 3072, dtype)))
    eps = torch.finfo(torch.float32).eps
    rows, main = [], None
    for kind, x in cases:
        q, s = K.int8_quantize_kernel(x)
        wq, ws = ref.int8_quantize_ref(x)
        sync()
        N, D = x.shape
        check(torch.equal(q, wq), f"int8 {kind} {N, D} {x.dtype}: q differs "
              f"from the plain version at {int((q != wq).sum())} elements")
        rel = float(((s - ws).abs() / ws).max())
        check(rel <= INT8_SCALE_RTOL, f"int8 {kind} {N, D}: scale rel {rel}")
        xf = x.float()
        err = (ref.int8_dequantize_ref(q, s) - xf).abs()
        check(bool((err <= s[:, None] / 2 + eps * xf.abs()).all()),
              f"int8 {kind} {N, D}: dequantization error over half a step")
        if kind == "ties":
            check(q[2, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]
                  and q[3, :9].tolist() == q[2, :9].tolist()
                  and not bool(q[1].any()), "int8: ties not half to even")
        b_ms, b_by = bound_ms(N * D * (x.element_size() + 1) + 4 * N,
                              5 * N * D)
        row = dict(kind=kind, shape=[N, D], dtype=str(x.dtype)[6:],
                   plan=_plan(K, N, D, x.dtype,
                              aligned=x.data_ptr() % 16 == 0),
                   max_abs_err=float((q.int() - wq.int()).abs().max()),
                   scale_max_rel_err=rel,
                   max_dequant_err_over_half_step=float(
                       (err / (s[:, None] / 2)).max()),
                   ms=time_ms(lambda: K.int8_quantize_kernel(x)),
                   plain_ms=time_ms(lambda: ref.int8_quantize_ref(x)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        if kind == "eo_payload":
            main = row
    emit("int8_quantize", cases=rows, launch_floor_ms=launch_floor_ms())
    return main


# --------------------------------------------------------------------------
# the space-ground scheduler: the system's own main path
# --------------------------------------------------------------------------

def _sg_trace(first_pass: int, vocab: int) -> list:
    """space_ground's requests: arrivals from SG_LEAD ticks before the
    first pass opens, SG_GAP ticks apart; every third at priority 1."""
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(SG_SEED)
    out = []
    for i in range(SG_REQUESTS):
        S = int(rng.integers(SG_PROMPTS[0], SG_PROMPTS[1] + 1))
        out.append(Request(
            prompt=rng.integers(1, vocab, S).astype(np.int32),
            max_new=int(rng.integers(SG_MAX_NEW[0], SG_MAX_NEW[1] + 1)),
            arrival_t=float(first_pass - SG_LEAD + SG_GAP * i),
            priority=int(i % 3 == 2)))
    return out


def _timed_calls(obj, name: str) -> list:
    """Wrap ``obj.<name>`` (an instance's bound method) so that every call
    appends (perf_counter at entry, seconds, return value) to the list
    returned.  The wrapper holds ``obj``: ``delattr(obj, name)`` when done,
    or ``obj`` lives on until the garbage collector's next cycle pass."""
    calls, orig = [], getattr(obj, name)

    def call(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        calls.append((t, time.perf_counter() - t, out))
        return out
    setattr(obj, name, call)
    return calls


def _drained(eng) -> bool:
    a = eng.slots.allocator
    return a.in_use == 0 and a.reserved == 0 and a.n_live_refs() == 0


def _profile_ticks(eng, n: int) -> dict:
    """Run torch.profiler (device activity) over ``n`` of ``eng``'s
    unified steps, from the first one that starts with a sequence in a
    slot: wraps the instance's ``_unified_step`` (the caller deletes the
    wrapper).  The dict returned gets the window's wall seconds (a sync
    at each end) and the device seconds the profiler saw in it: the
    scheduler loop's other work in those ticks (the ground tier's steps,
    the lane, the gate) falls inside the window too."""
    from torch.profiler import ProfilerActivity, profile
    win, orig = dict(left=n, prof=None), eng._unified_step

    def step():
        if win["prof"] is None and win["left"] and eng.slots.any_active():
            sync()
            win["prof"] = profile(activities=[ProfilerActivity.CUDA])
            win["prof"].__enter__()
            win["t0"] = time.perf_counter()
        orig()
        if win["prof"] is not None and win["left"]:
            win["left"] -= 1
            if not win["left"]:
                sync()
                win["wall_s"] = time.perf_counter() - win["t0"]
                win["prof"].__exit__(None, None, None)
                win["device_s"] = sum(
                    getattr(ev, "device_time_total", 0) or 0
                    for ev in win["prof"].key_averages()) / 1e6
                win["prof"] = False
    eng._unified_step = step
    return win


def _sg_run(params, device: str, profiled: bool = False) -> dict:
    """One space_ground replay on fresh engines over ``params`` (ONBOARD,
    GROUND): the scheduler, its report, the run's wall clock, the first
    admission's time, each checkpoint's (time, seconds, bytes), the
    launch counts and peak memory; with ``profiled`` (on cuda) the window
    ``_profile_ticks`` took."""
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.core.link import ContactSchedule
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.scheduler import SpaceGroundScheduler
    S, C = TP.SCHEDULER, TP.CASCADE
    sat = ContinuousEngine(TP.ONBOARD, params[0], n_slots=SG_SLOTS,
                           max_seq=SG_MAX_SEQ, pool_pages=SG_SAT_POOL,
                           prefill_budget_tokens=S["prefill_budget_tokens"],
                           draft_k=S["draft_k"])
    gnd = ContinuousEngine(TP.GROUND, params[1], n_slots=SG_SLOTS,
                           max_seq=SG_MAX_SEQ, draft_k=S["draft_k"])
    out = dict(sat=sat, gnd=gnd, window=None)
    with tempfile.TemporaryDirectory() as tmp:
        sg = SpaceGroundScheduler(
            sat, gnd,
            schedule=ContactSchedule(
                contact_duration_s=S["contact_duration_s"],
                contacts_per_day=S["contacts_per_day"]),
            gate=ConfidenceGate(C["confidence_metric"],
                                C["confidence_threshold"]),
            s_per_step=S["s_per_step"], overlap=S["overlap"],
            comm_reserve_pages=S["comm_reserve_pages"],
            delta_spill=S["delta_spill"], frame_bytes=S["frame_bytes"],
            link_max_retries=S["link_max_retries"],
            checkpoint_every=S["checkpoint_every"],
            checkpoint_path=os.path.join(tmp, "sat.ckpt"),
            speculative=S["speculative"])
        out.update(sg=sg, reqs=_sg_trace(sg.windows[0][0],
                                         TP.ONBOARD.vocab_size))
        out["ckpts"] = _timed_calls(sg.sat, "checkpoint")
        out["admits"] = _timed_calls(sat, "_admit")
        sync()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        if profiled and device == "cuda":
            out["window"] = _profile_ticks(sat, SG_PROFILE_TICKS)
        out["t0"] = time.perf_counter()
        out["rep"] = sg.run(out["reqs"])
        sync()
        out["t1"] = time.perf_counter()
    delattr(sat, "_admit")
    delattr(sg.sat, "checkpoint")
    if out["window"] is not None:
        delattr(sat, "_unified_step")
    out["counts"] = ops.launch_counts()
    out["peak"] = (torch.cuda.max_memory_allocated() if device == "cuda"
                   else None)
    return out


def phase_space_ground(device: str = "cuda") -> dict:
    """SpaceGroundScheduler over the tiansuan pair at its own widths in
    bf16, under every TP.SCHEDULER default (overlap, a 2-page hold, delta
    spills, a prefill budget of 16, framed ARQ at 1024-byte frames, a
    checkpoint every 64 ticks, speculative draft-id escalation with
    draft_k 8) and the cascade's gate.  Every decode step of either tier
    runs the paged kernel (one launch a layer), every finished satellite
    sequence one gate launch.  The same replay runs once more under
    torch.profiler for the device's busy share of the serving window."""
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.models import transformer as T
    S = TP.SCHEDULER
    params = (T.init_params(TP.ONBOARD, seed=0, device=device),
              T.init_params(TP.GROUND, seed=1, device=device))
    run = _sg_run(params, device)
    sg, sat, gnd, reqs, rep = (run[k] for k in ("sg", "sat", "gnd", "reqs",
                                                "rep"))
    ckpts, counts, peak = run["ckpts"], run["counts"], run["peak"]
    t0, t1 = run["t0"], run["t1"]
    prof = _sg_run(params, device, profiled=True)
    win = prof["window"] or {}
    repeat_exact = all(np.array_equal(rep.tokens[a.rid],
                                      prof["rep"].tokens[b.rid])
                       for a, b in zip(reqs, prof["reqs"]))
    led = rep.ledger.summary()
    st = rep.sat_stats
    serve_s = t1 - run["admits"][0][0]
    compute_ticks = round(led["energy_compute_j"]
                          / sg.energy.inference_energy_j(1, sg.s_per_step))
    sat_tok = sum(len(r.tokens) for r in rep.sat_results.values())
    gnd_tok = sum(len(r.tokens) for r in rep.ground_results.values())
    by_rid = {r.rid: r for r in reqs}
    check(sorted(rep.tokens) == sorted(by_rid) and not rep.undelivered,
          f"space_ground: answered {sorted(rep.tokens)}, undelivered "
          f"{rep.undelivered}")
    for rid, toks in rep.tokens.items():
        check(len(toks) == by_rid[rid].max_new
              and bool(((toks >= 0) & (toks < TP.ONBOARD.vocab_size)).all()),
              f"space_ground: request {rid} answered {toks}")
    for key in ("n_spills", "n_delta_spills", "n_resumes"):
        check(st[key] >= 1, f"space_ground: {key} = {st[key]}")
    check(len(ckpts) >= 1 and all(n > 0 for _, _, n in ckpts),
          "space_ground: no checkpoint written")
    check(_drained(sg.sat.engine) and _drained(gnd)
          and len(sg.sat.store) == 0 and sg.sat.held_pages == 0,
          "space_ground: pools or spill store not drained")
    check(prof["counts"] == counts and prof["rep"].sat_stats["n_spills"]
          == st["n_spills"], "space_ground: the profiled replay took "
          "another course")
    check(device != "cuda" or "device_s" in win,
          f"space_ground: the profiled window closed after "
          f"{SG_PROFILE_TICKS - win.get('left', 0)} ticks")
    want_paged = (TP.ONBOARD.n_layers * sat.decode_steps_total
                  + TP.GROUND.n_layers * gnd.decode_steps_total)
    check(counts["paged_decode_attention"] == want_paged,
          f"space_ground: paged launches {counts['paged_decode_attention']}"
          f" != {TP.ONBOARD.n_layers} x {sat.decode_steps_total} + "
          f"{TP.GROUND.n_layers} x {gnd.decode_steps_total}")
    check(counts["confidence_gate"] == led["items_total"] == len(reqs),
          f"space_ground: gate launches {counts['confidence_gate']} != "
          f"{led['items_total']} sequences classified")
    sizes = [n for _, _, n in ckpts]
    emit("space_ground", onboard=TP.ONBOARD.name, ground=TP.GROUND.name,
         dtype=TP.ONBOARD.param_dtype, scheduler=S, n_requests=len(reqs),
         first_pass=list(sg.windows[0]), arrivals=[reqs[0].arrival_t,
                                                    reqs[-1].arrival_t],
         wall_s=t1 - t0, serve_wall_s=serve_s, ticks=sg.sat.clock,
         compute_ticks=compute_ticks,
         decode_steps_in_window=rep.decode_steps_in_window,
         sat_decode_steps=sat.decode_steps_total,
         ground_decode_steps=gnd.decode_steps_total,
         sat_tokens=sat_tok, ground_tokens=gnd_tok,
         tokens_per_s=(sat_tok + gnd_tok) / serve_s,
         serve_ms_per_compute_tick=serve_s * 1e3 / max(compute_ticks, 1),
         escalated=len(rep.escalated), ledger=led,
         checkpoints=dict(n=len(ckpts), bytes_mean=float(np.mean(sizes)),
                          bytes_max=max(sizes),
                          s_per_write=float(np.mean([d for _, d, _ in
                                                     ckpts]))),
         spill=dict(spill_bytes=st["spill_bytes"],
                    full_spill_equiv=st["spill_bytes_full_equiv"],
                    n_spills=st["n_spills"],
                    n_delta_spills=st["n_delta_spills"],
                    n_resumes=st["n_resumes"],
                    resume_s_mean=st["resume_latency_s_mean"]),
         lane=rep.lane_stats, spec=rep.spec_stats, launches=counts,
         peak_mem_bytes=peak,
         profiled=dict(ticks=SG_PROFILE_TICKS, wall_s=win.get("wall_s"),
                       device_s=win.get("device_s"),
                       busy_share=(win["device_s"] / win["wall_s"]
                                   if "device_s" in win else None),
                       tokens_equal_first_run=repeat_exact))
    return counts


def _fault_trace(vocab: int) -> list:
    """benchmarks/serving_throughput.py::_fault_trace."""
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(3)
    return [Request(prompt=rng.integers(1, vocab, int(rng.integers(8, 14)))
                    .astype(np.int32), max_new=int(rng.integers(10, 18)),
                    arrival_t=float(i * 2)) for i in range(8)]


def _serve_fault(cfgs, params, trace, faulted: bool, tmp: str):
    """benchmarks/serving_throughput.py::_serve_fault on the (ONBOARD,
    GROUND) pair: one replay, with every fault of FR_PLAN armed or none.
    The scheduler holds the only reference to the satellite engine, so a
    reboot frees it.  Returns (report, scheduler, injector, a weak
    reference to the first satellite engine, memory before the run)."""
    import gc
    import weakref
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.core.link import ContactSchedule
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.scheduler import SpaceGroundScheduler
    kw = dict(schedule=ContactSchedule(contact_duration_s=4.0,
                                       contacts_per_day=8640, seed=3),
              gate=ConfidenceGate("max_prob", FR_GATE_THRESHOLD),
              s_per_step=1.0, horizon_s=7200.0,
              comm_reserve_pages=FR_RESERVE_PAGES)
    inj = None
    if faulted:
        inj = FaultInjector(FaultPlan(**FR_PLAN))
        kw.update(faults=inj, frame_bytes=FR_FRAME_BYTES,
                  link_max_retries=FR_MAX_RETRIES,
                  checkpoint_every=FR_CHECKPOINT_EVERY,
                  checkpoint_path=os.path.join(tmp, "fault.ckpt"))
    sg = SpaceGroundScheduler(
        ContinuousEngine(cfgs[0], params[0], n_slots=FR_SAT_SLOTS,
                         max_seq=FR_MAX_SEQ, kv_layout="paged",
                         page_size=FR_SAT_PAGE_SIZE,
                         pool_pages=FR_SAT_POOL_PAGES,
                         prefill_budget_tokens=8),
        ContinuousEngine(cfgs[1], params[1], n_slots=FR_SAT_SLOTS,
                         max_seq=FR_MAX_SEQ), **kw)
    first = weakref.ref(sg.sat.engine)
    gc.collect()
    sync()
    before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
        else 0
    rep = sg.run([r.clone() for r in trace])
    sync()
    return rep, sg, inj, first, before


def _in_order(rep, n: int) -> tuple:
    """(final tokens, satellite tokens, escalated positions, rids) in
    submission order (the clones' rids follow the trace's order); fails
    unless all ``n`` requests were answered."""
    rids = sorted(rep.sat_results)
    check(len(rids) == n, "fault replay: answers missing")
    esc = sorted(rids.index(r) for r in rep.escalated)
    return ([rep.tokens[r] for r in rids],
            [rep.sat_results[r].tokens for r in rids], esc, rids)


def phase_space_ground_faults(device: str = "cuda") -> None:
    """The reference bench's fault replay on the tiansuan pair in fp32
    (TF32 off): the faulted run equals the fault-free run token for token,
    every injected corruption is detected, the frame ledger is conserved,
    exactly one reboot happens, pools and the spill store drain, and the
    pre-reboot satellite engine is freed (memory back within one pool).
    Then the faulted replay once more on the CPU: the same answers apart
    from counted near-ties, escalations apart only at a confidence within
    NEAR_TIE of the threshold."""
    import gc
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.core.confidence import confidence_metrics
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgs = tuple(c.with_(param_dtype="float32", activation_dtype="float32")
                 for c in (TP.ONBOARD, TP.GROUND))
    cpu_params = (T.init_params(cfgs[0], seed=0, device="cpu"),
                  T.init_params(cfgs[1], seed=1, device="cpu"))
    params = tuple(_to(p, device) for p in cpu_params)
    trace = _fault_trace(cfgs[0].vocab_size)
    with tempfile.TemporaryDirectory() as tmp:
        clean = _serve_fault(cfgs, params, trace, False, tmp)[0]
        t0 = time.perf_counter()
        rep, sg, inj, first, before = _serve_fault(cfgs, params, trace, True,
                                                   tmp)
        wall = time.perf_counter() - t0
        rep_cpu = _serve_fault(cfgs, cpu_params, trace, True, tmp)[0]
    alive_before_gc = first() is not None
    gc.collect()
    after = torch.cuda.memory_allocated() if device == "cuda" else 0
    pool = sg.sat.engine.slots.cache_bytes()
    toks, sat_toks, esc, _ = _in_order(rep, len(trace))
    c_toks, c_sat, c_esc, _ = _in_order(clean, len(trace))
    check(all(np.array_equal(a, b) for a, b in zip(toks, c_toks))
          and all(np.array_equal(a, b) for a, b in zip(sat_toks, c_sat))
          and esc == c_esc,
          "space_ground_faults: the faulted run differs from the fault-free "
          "run")
    ls, st = rep.lane_stats, rep.sat_stats
    detected = ls["n_corruptions_detected"] + \
        st["n_spill_corruptions_detected"]
    check(detected == inj.n_corruptions_injected > 0,
          f"space_ground_faults: {detected} detected of "
          f"{inj.n_corruptions_injected} injected")
    check(abs(ls["frame_bytes_attempted"] - (ls["bytes_sent"]
              + ls["bytes_lost"] + ls["bytes_corrupt"])) < 1e-6
          and ls["n_silent_corruptions"] == 0,
          f"space_ground_faults: frame ledger not conserved {ls}")
    check(rep.n_reboots == 1 and inj.n_crashes == 1,
          f"space_ground_faults: {rep.n_reboots} reboots")
    check(not rep.undelivered and _drained(sg.sat.engine)
          and _drained(sg.ground) and len(sg.sat.store) == 0,
          "space_ground_faults: undelivered answers or pools not drained")
    check(not alive_before_gc and abs(after - before) < pool,
          f"space_ground_faults: the pre-reboot engine was not freed "
          f"(alive {alive_before_gc}, memory {before} -> {after}, pool "
          f"{pool} bytes)")
    # the same faulted replay on the CPU
    ct, cs, cesc, crids = _in_order(rep_cpu, len(trace))
    check(rep_cpu.n_reboots == 1 and rep_cpu.lane_stats == ls,
          "space_ground_faults: the cpu replay took another course")
    near_sat, d_sat = _near_ties("sat_cpu", sat_toks, cs,
                                 [r.prompt for r in trace], cpu_params[0],
                                 cfgs[0])
    both = sorted(set(esc) & set(cesc))
    near_gnd, d_gnd = _near_ties(
        "ground_cpu", [toks[i] for i in both], [ct[i] for i in both],
        [trace[i].prompt for i in both], cpu_params[1], cfgs[1])
    gate_edge = []
    for i in sorted(set(esc) ^ set(cesc)):
        logits = rep_cpu.sat_results[crids[i]].logits_last
        conf = float(confidence_metrics(torch.from_numpy(logits[None]))
                     ["max_prob"][0])
        check(abs(conf - FR_GATE_THRESHOLD) < NEAR_TIE,
              f"space_ground_faults: request {i} escalates on one device "
              f"only at confidence {conf}")
        gate_edge.append(dict(request=i, confidence=conf))
    emit("space_ground_faults", dtype="float32", plan=FR_PLAN,
         frame_bytes=FR_FRAME_BYTES, max_retries=FR_MAX_RETRIES,
         checkpoint_every=FR_CHECKPOINT_EVERY, wall_s=wall,
         ticks=sg.sat.clock, n_requests=len(trace), escalated=len(esc),
         token_exact_vs_fault_free=True, n_reboots=rep.n_reboots,
         injected=dict(n_frames_lost=inj.n_frames_lost,
                       n_frame_corruptions=inj.n_frame_corruptions,
                       n_spill_corruptions=inj.n_spill_corruptions,
                       n_windows_truncated=inj.n_windows_truncated),
         detected=detected, lane=ls,
         redo_from_corruption=st["n_redo_from_corruption"],
         memory_before=before, memory_after=after, sat_pool_bytes=pool,
         cpu=dict(sat_near_ties=near_sat, ground_near_ties=near_gnd,
                  divergences=d_sat + d_gnd,
                  escalations_at_the_threshold=gate_edge))


def _ssm_f64(x, dt, A, Bm, Cm, chunk):
    """The SSD plain version run in float64 on the same inputs."""
    from repro_torch.kernels import ref
    saved = ref.F32
    ref.F32 = torch.float64
    try:
        return ref.ssm_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)
    finally:
        ref.F32 = saved


@contextlib.contextmanager
def _held_to_plain(held: dict):
    """Inside the block every flash, decode (paged and contiguous) and
    SSD launch is also computed by its plain version on the same inputs:
    the kernels held to their plain versions at the main path's own
    inputs and strides.  Appends to ``held[name]`` for flash and the two
    decode kernels each launch's share of PAGED_TOL, and to
    ``held["ssm_chunk_scan"]`` each launch's errors
    against the plain version in float64: the kernel's and the fp32
    plain version's max error for y and the state (see
    SSD_PATH_FACTOR), and the share of SSM_TOL the kernel uses against
    the fp32 plain version."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import paged_decode_attention as KP
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as KS
    flash, ssm = KF.flash_attention_kernel, KS.ssm_chunk_scan_kernel
    paged = KP.paged_decode_attention_kernel
    decode = KD.decode_attention_kernel

    def holding(name, kernel, plain):
        """kernel, each launch's share of PAGED_TOL against plain on its
        own inputs appended to held[name]."""
        def call(q, *a, **kw):
            out = kernel(q, *a, **kw)
            held.setdefault(name, []).append(_share_of_tolerance(
                out, plain(q, *a, **kw), *PAGED_TOL[q.dtype]))
            return out
        return call

    def held_ssm(x, dt, A, Bm, Cm, *, chunk=256):
        y, h = ssm(x, dt, A, Bm, Cm, chunk=chunk)
        wy, wh = ref.ssm_chunk_scan_ref(x, dt, A, Bm, Cm, chunk)
        y64, h64 = _ssm_f64(x, dt, A, Bm, Cm, chunk)
        errs = {}
        for name, k, w, t in (("y", y, wy, y64), ("state", h, wh, h64)):
            errs[name] = dict(kernel=float((k.double() - t).abs().max()),
                              plain_f32=float((w.double() - t).abs().max()),
                              max_abs=float(t.abs().max()))
        errs["share_of_ssm_tol_vs_plain_f32"] = max(
            _share_of_tolerance(y, wy, *SSM_TOL),
            _share_of_tolerance(h, wh, *SSM_TOL))
        held.setdefault("ssm_chunk_scan", []).append(errs)
        return y, h

    KF.flash_attention_kernel = holding("flash_attention", flash,
                                        ref.flash_attention_ref)
    KP.paged_decode_attention_kernel = holding(
        "paged_decode_attention", paged, ref.paged_decode_attention_ref)
    KD.decode_attention_kernel = holding("decode_attention", decode,
                                         ref.decode_attention_ref)
    KS.ssm_chunk_scan_kernel = held_ssm
    try:
        yield
    finally:
        KF.flash_attention_kernel, KS.ssm_chunk_scan_kernel = flash, ssm
        KP.paged_decode_attention_kernel = paged
        KD.decode_attention_kernel = decode


def _ssd_path_share(e: dict) -> float:
    """A held SSD launch's error against float64 over its bound:
    SSD_PATH_FACTOR times the fp32 plain version's error plus
    SSM_TOL's atol, the larger for y and the state (1.0 uses it all)."""
    return max(e[k]["kernel"] / (SSD_PATH_FACTOR * e[k]["plain_f32"]
                                 + SSM_TOL[0]) for k in ("y", "state"))


def _prefill_checks(params, cfg, tokens: np.ndarray, what: str) -> dict:
    """Two more prefills of a serve phase's prompts, after its launch
    counts are read.  One under torch.profiler: the device's busy share
    of the prefill's wall time (the rest is the host's) and its largest
    kernels.  One with every flash and SSD launch held to its plain
    version on its own inputs (``_held_to_plain``), checked: flash
    within the smoke's tolerance, the SSD scan within SSD_PATH_FACTOR.
    Returns both for the phase's line (``_check_held`` checks them)."""
    from repro_torch.models import transformer as T
    batch = {"tokens": torch.from_numpy(tokens).to(params["embed"].device)}
    us, wall_us = profile_device(lambda: T.prefill(params, cfg, batch),
                                 reps=3)
    busy = sum(us.values())
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    held = {}
    with _held_to_plain(held):
        T.prefill(params, cfg, batch)
        sync()
    out = dict(profiled_prefill=dict(
        wall_s=wall_us / 1e6, device_busy_s=busy / 1e6,
        device_busy_share=busy / wall_us, top_kernels_us=dict(top)),
        held_to_plain=_shares(held))
    if held.get("ssm_chunk_scan"):
        errs = held["ssm_chunk_scan"]
        shares = [_ssd_path_share(e) for e in errs]
        worst = max(range(len(errs)), key=lambda i: shares[i])
        out["held_to_plain"]["ssm_chunk_scan"] = dict(
            launches=len(errs), factor=SSD_PATH_FACTOR,
            max_share=shares[worst],
            max_kernel_over_plain_f32_error=max(
                e[k]["kernel"] / max(e[k]["plain_f32"], 1e-30)
                for e in errs for k in ("y", "state")),
            max_share_of_ssm_tol_vs_plain_f32=max(
                e["share_of_ssm_tol_vs_plain_f32"] for e in errs),
            worst_launch=worst, worst_errors=errs[worst])
    return out


def _shares(held: dict) -> dict:
    """Launches and the largest share of PAGED_TOL per kernel held by
    ``_held_to_plain`` (the SSD scan is summarised by its caller)."""
    return {name: dict(launches=len(v), max_share=max(v))
            for name, v in held.items() if v and name != "ssm_chunk_scan"}


def _decode_checks(steps: "_StepTimes", launches: int,
                   profile: bool) -> dict:
    """The decode step ``steps`` captured, run again after its phase's
    counts are read.  With ``profile``, under torch.profiler: the
    device's busy share of the step's wall time (the rest is the
    host's), each decode kernel's microseconds, and the decode kernels'
    launches per step (one per attention layer: no merge kernel).  Then
    once with every decode launch held to its plain version on its own
    inputs.  ``launches``: the decode launches a step makes."""
    from repro_torch.models import transformer as T
    params, cfg, cache, a, kw = steps.captured

    def step():
        return T.decode_step(params, cfg, cache, *a, **kw)

    out = {}
    if profile:
        calls = {}
        us, wall_us = profile_device(step, reps=5, calls=calls)
        busy = sum(us.values())
        names = [k for k in us if "decode_kernel" in k or "split_kernel" in k
                 or "merge_kernel" in k]
        out["profiled_decode_step"] = dict(
            wall_s=wall_us / 1e6, device_busy_s=busy / 1e6,
            device_busy_share=busy / wall_us,
            decode_kernels_us={k: us[k] for k in names},
            decode_launches=sum(calls[k] for k in names),
            want_launches=launches,
            top_kernels_us=dict(sorted(us.items(), key=lambda kv: -kv[1])[:6]))
    held = {}
    with _held_to_plain(held):
        step()
        sync()
    out["held_to_plain"] = _shares(held)
    return out


def _check_held(out: dict, what: str) -> None:
    """Every launch that ``_prefill_checks`` or ``_decode_checks`` held
    to its plain version within its bound (max_share at most 1); a
    profiled decode step launched one decode kernel per attention layer
    and no merge kernel."""
    for name, row in out["held_to_plain"].items():
        check(row["max_share"] <= 1.0, f"{what}: a {name} launch on the "
              f"path is outside its bound (share {row['max_share']})")
    prof = out.get("profiled_decode_step")
    if prof:
        check(prof["decode_launches"] == prof["want_launches"]
              and not any("merge" in k for k in prof["decode_kernels_us"]),
              f"{what}: a decode step launched {prof['decode_kernels_us']} "
              f"({prof['decode_launches']} launches, want "
              f"{prof['want_launches']}, one a layer)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch                               # noqa: F401
    t0 = time.perf_counter()
    dev = phase_device()
    ptxas = phase_build()
    paged = phase_paged()
    gate = phase_gate()
    flash = phase_flash(ptxas)
    decode = phase_decode()
    ssm = phase_ssm_scan(ptxas)
    phase_cross_check()
    counts, paged_tokens = phase_full_serve()
    fixed_counts = phase_fixed_serve()
    phase_contiguous_serve(paged_tokens)
    phase_hybrid_cross_check()
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    zamba = get_config("zamba2-7b")
    t1 = time.perf_counter()
    zparams = T.init_params(zamba, seed=0, device="cuda")
    sync()
    emit("hybrid_init", arch=zamba.name, seconds=time.perf_counter() - t1,
         param_bytes=_tree_bytes(zparams))
    hybrid_counts = phase_hybrid_fixed_serve(zamba, zparams)
    phase_hybrid_continuous_serve(zamba, zparams)
    del zparams
    torch.cuda.empty_cache()
    eo_run = phase_eo_figures()
    phase_eo_cross_check(eo_run["tiers"], eo_run["threshold"])
    scene_counts, eo_rows = phase_eo_scene(eo_run["tiers"],
                                           eo_run["threshold"])
    int8 = phase_int8(eo_rows)
    sg_counts = phase_space_ground()
    phase_space_ground_faults()
    check(gate["plan"] is not None and int8["plan"] is not None,
          "the gate and int8 libraries must report their plans")
    kernels = []
    csrc = "src/repro_torch/kernels/csrc/"
    for name, src, replaces, row, path, launches in (
            ("paged_decode_attention", csrc + "paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:79", paged,
             "full_serve", counts),
            ("confidence_gate", csrc + "conf_gate.cu",
             "src/repro/kernels/conf_gate.py:86", gate, "full_serve",
             counts),
            ("flash_attention", csrc + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:76", flash,
             "fixed_serve", fixed_counts),
            ("decode_attention", csrc + "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:66", decode,
             "fixed_serve", fixed_counts),
            ("ssm_chunk_scan", csrc + "ssm_chunk_scan.cu",
             "src/repro/kernels/ssm_scan.py:73", ssm,
             "hybrid_fixed_serve", hybrid_counts),
            ("int8_quantize", csrc + "int8_quant.cu",
             "src/repro/kernels/int8_quant.py:33", int8, "eo_scene",
             scene_counts)):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces, launches=launches[name],
                            path=path,
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"],
                            bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"],
                            library_ms=row["library_ms"],
                            shape=row["shape"], dtype=row["dtype"]))
        if name in ("paged_decode_attention", "confidence_gate"):
            kernels[-1]["space_ground_launches"] = sg_counts[name]
    emit("done", seconds=time.perf_counter() - t0)
    print(dev["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
