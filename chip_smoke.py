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
               (1, 512); paged and contiguous decode also at
               qwen3-moe's 32/4 heads of 128, flash at deepseek-v3's
               MLA prefill, 128/128 heads with q/k head dim 192 and v
               head dim 128, and the gate at both models' vocabularies)
               and a few others,
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
               bits over 20 launches; flash also launched with its
               log-sum-exp output in every case (out bit for bit, the lse
               held to the plain version's at atol, rtol 1e-5) and its
               autograd Function's dq, dk, dv held to autograd through
               the plain version in fp32 (bf16: within twice the error of
               the same backward on the plain forward), with the forward
               with the lse, the plain backward and SDPA's backward timed
               at the timed shapes; the cases include the training
               phases' shapes (smollm 8 x 256 at 15/5 heads of 64; the
               tiansuan pair's 4/2 and 8/4 heads of 48 at 8 x 96 and
               8 x 95; zamba2's 32/32 heads of 112 at 8 x 256) and the
               dense configs' (granite's 48 query heads over one KV head
               of 128 at 4 x 512, timed, and ragged at 2 x 333; a group
               of 12; qwen1.5-4b's 20/20 heads of 128); and flash at
               a query length other than the key length (whisper's
               cross-attention, 8 x 64 against 1500 frames, and its
               encoder's 8 x 1500, both non-causal and timed beside SDPA;
               causal pairs 200 x 333 and 333 x 200) and at qwen2-vl's
               4 x 512 with 12/2 heads of 128; decode also at whisper's
               cross cache (8, 1500, 6/6, 64) and qwen2-vl's 12/2 heads,
               and with its log-sum-exp at the shapes seq_cut's ranks
               run it at, granite's (4, 1024, 48/1, 128) and qwen1.5-4b's
               (4, 1024, 20/20, 128), a row of kv_len 0 among each (out
               0, lse -1e30 exactly)
  cross_check  smollm-360m widths at 4 layers in fp32 (TF32 off) serve the
               same requests through the paged and the contiguous
               ContinuousEngine on cuda and the paged one on cpu, and a
               same-length batch through ServingEngine on cuda and cpu:
               identical greedy tokens, apart from counted near-ties
  full_serve   smollm-360m at full width and depth in bf16 serves 16
               requests through the paged ContinuousEngine.run (8 slots,
               max_seq 2048) and the confidence gate decides every result;
               then one warm decode step of the run again: counted
               (one decode launch a layer; one such launch alone,
               captured in a CUDA graph, is one kernel), under
               torch.profiler (the device's busy share of its wall
               time, the decode kernel's microseconds) and with every
               decode launch held to its plain version
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
  shared_prefix
               smollm-360m's widths at 8 layers in fp32 (TF32 off;
               uncut, 32, until sharded_train; 16 until seq_cut) through
               the paged
               ContinuousEngine with prefix_cache=True and then False on
               the same trace and pool: 32 Poisson arrivals over 4 system
               headers of 256 tokens plus unique tails, and one request
               that is exactly a header (a copy-on-write); identical
               tokens apart from counted near-ties, fewer prefill tokens
               and a lower page peak shared, hits and a fork, the pool
               drained after the index is cleared
  speculative  the tiansuan GROUND tier uncut in fp32 through
               SpeculativeDecoder (k = draft_k = 8) drafting for itself
               (every draft accepted, the CPU's round count) and drafted
               for by ONBOARD; tokens equal greedy_generate on the card,
               verify passes run
  constellation
               configs/tiansuan_constellation.py's CONSTELLATION uncut in
               fp32: 3 ONBOARD satellites, 2 stations, 24 requests via
               satellite 0; the pooled replay (handover), the
               independent pairs and a solo scheduler, token-exact apart
               from counted near-ties, one owner per rid every tick,
               everything delivered and drained; then the pooled replay
               under the reference bench's fault plan: every corruption
               detected
  moe_serve    qwen3-moe-30b-a3b's widths at 8 layers in bf16 (uncut,
               48 layers and 61 GB, until sharded_train needed the
               time, 24 until seq_cut did; 128 experts top-8, seeded
               random weights, initialised one matrix at a time): 16
               Poisson requests (prompts 32-192,
               max_new 16-32) through the paged ContinuousEngine (8
               slots, max_seq 512, the default prefill budget), every
               result gated, then ServingEngine.generate on 4 x 128
               prompts, 16 new tokens: tokens/s, wall, prefill and
               decode seconds (CUDA events), peak memory, the capacity
               loop's retries and their overflow counts; launch counts
               exact (paged decode 48 a decode step, flash 48 a
               fixed-slot prefill attempt, contiguous decode 48 a
               fixed-slot step, one gate a result); then a shorter rerun
               of both engines with every flash and decode launch held
               to its plain version.  Then moe_invariants: its widths
               at 4 layers in fp32 (TF32 off): paged (chunks of 64) =
               paged in one chunk = contiguous = both under the static
               drop-free capacity = fixed-slot, the dynamic-capacity
               prefill's argmax = the static one's, and one
               preempt/resume round trip (spill) = the solo run
  mla_serve    deepseek-v3 at its published widths cut to 4 layers (3
               dense-MLP, 1 MoE of 256 experts top-8 with the shared
               expert; MTP params; 31.6 GB in bf16) through the same
               two engines: flash at q/k 192, v 128 in the fixed-slot
               prefill (4 launches an attempt), MLA's absorbed attention
               plain on the paged and contiguous latent caches; then
               mla_invariants as above in fp32 at the same widths
               (63 GB)
  train_step   one make_train_step step at smollm-360m's widths cut to
               2 layers, on train_smollm's first batch, TF32 off: the
               kernel's path in fp32 and in bf16 against the plain path
               in fp32 (chunked attention under autograd, no remat, no
               kernel): the loss, each leaf of the clipped gradient (the
               first AdamW moment) and the params' update, each within
               its stated tolerance
  train_smollm launch/train.py's loop (training/loop.py::train) on
               smollm-360m at full width in bf16 (32 x 960, 15/5 heads
               of 64, vocab 49152): 20 steps of 8 x 256 tokens of the
               TokenStream (seed 0), lr 1e-3, warmup 10, remat on; the
               loss falls, flash launches exactly 32 x 2 a step (forward
               and remat's recompute) and nothing else runs; each step's
               time between CUDA events, tokens/s, peak memory, and one
               more step cut into forward, backward (flash's plain
               backward among it) and update
  lm_cascade   tests/test_lm_cascade.py on the card: the tiansuan pair in
               bf16 trained (ONBOARD 30 steps, GROUND 90, seq 96, batch
               8, lr 2e-3, warmup 5), the gate calibrated to a 0.6 budget
               on the held-out batch, the collaborative and onboard-only
               cascades through CollaborativeEngine (the gate kernel on
               the CUDA logits); the reference test's four assertions,
               exact flash and gate launches, the figures beside the JAX
               package's on the host CPU
  granite_20b_serve / qwen1_5_4b_serve  (dense_configs_serve)
               granite-20b uncut in bf16 (52 x 6144, 48/1 heads of 128,
               GELU MLP, 40.6 GB) and then qwen1.5-4b uncut (40 x 2560,
               20/20 heads of 128, qkv bias, vocab 151936) through both
               engines as moe_serve drives them: 8 Poisson requests
               (prompts 64-512, max_new 16-32) through the paged
               ContinuousEngine (8 slots, max_seq 576), gated, then
               ServingEngine.generate on 4 x 512, 16 new tokens; launch
               counts exact (flash 52 / 40 a prefill, paged decode 52 /
               40 a decode step, contiguous decode 52 / 40 a fixed-slot
               step), the profiled and held reruns; then
               granite_invariants: granite's widths at 2 layers in fp32,
               paged = one-chunk paged = contiguous = fixed-slot and a
               preempt/resume round trip
  xlstm_serve  xlstm-1.3b's widths at 24 blocks of 2048 in bf16 (21
               mLSTM, 3 sLSTM; uncut, 48, until sharded_train) through the contiguous ContinuousEngine (8 slots,
               exact-length admission, prompts 32-256) and
               ServingEngine.generate on 4 x 256, gated, no attention
               kernel; tokens/s, the decode step's time and busy share;
               then xlstm_invariants: its widths at two blocks in fp32,
               prefill + decode against one forward
  train_xlstm / train_zamba2 / zamba_train_step  (train_families)
               10 steps of 8 x 256 (lr 1e-3, warmup 3, remat) of
               xlstm-1.3b's widths at 16 layers and of zamba2-7b's at 12
               in bf16, the loss falling; zamba2's SSD scan 2 launches a
               Mamba2 block a step (the forward and remat's recompute;
               its backward is the plain scan's), flash 2 a unit, xLSTM
               none; then one zamba2 step at 6 layers, TF32 off, the
               kernels' path in fp32 and bf16 against the plain path in
               fp32 (chunked attention, the plain SSD scan), held as
               train_step holds smollm's
  whisper_serve / qwen2_vl_serve  (side_serve)
               whisper-tiny uncut in bf16 (4 + 4 layers of 384, 6/6 heads
               of 64, vocab 51865, 1500 frames) and qwen2-vl-2b uncut
               (28 x 1536, 12/2 heads of 128, M-RoPE, tied vocab 151936,
               256 patches) through ServingEngine.generate with their
               side inputs (0.02 * randn frames or patch embeddings):
               8 prompts of 64 tokens, 64 new, max_seq 448; 4 requests
               of 256 patches + 256 text tokens, 32 new, max_seq 1024;
               the gate decides each batch.  Launch counts exact (flash
               12 a whisper prefill: 4 encoder, 4 self, 4 cross at Sq =
               64 against Skv = 1500; 28 a qwen2-vl prefill; contiguous
               decode 8 a whisper step, 4 of them on the static cross
               cache, 28 a qwen2-vl step; one gate), one kernel node a
               decode launch, a profiled and held decode step and
               prefill
  audio_vlm_invariants
               both uncut in fp32 (TF32 off): prefill 64 text tokens
               (qwen2-vl after its 256 patches) and decode one more
               against one forward, within SIDE_INV_TOL, the same argmax
  train_whisper / train_qwen2_vl  (train_audio_vlm)
               10 steps of 8 x 128 text tokens of both uncut in bf16
               through training/loop.py::train with launch/train.py's
               side inputs (lr 1e-3, warmup 3, remat): the loss falls,
               flash exactly 2 a layer a step (whisper's encoder, self
               and cross layers), nothing else
  sharded_serve
               ContinuousEngine(mesh=...) on 4 processes on the one card
               (cuda:0 for every rank, gloo: one card time-sliced by 4
               processes, not a tensor-parallel speed), each building the
               full seeded params in turn, keeping its slices and freeing
               the rest: qwen1.5-4b's widths at 1 layer in bf16 (5/5
               heads of 128 a rank
               through the paged kernel) on DENSE_TRAFFIC, qwen3-moe-30b-a3b's
               widths at 1 layer (8/1 heads and 32 experts a rank) and
               deepseek-v3's at 2 (one dense-MLP and one MoE layer; the
               latent rank 128 and krope 16 a rank) on 4 arrivals of
               32-192 tokens, each beside rank 0's
               one-rank run: every rank's tokens identical, n_kv_shards 4,
               each rank's measured pool bytes equal to the reported
               kv_bytes_per_device, paged launches = layers x decode steps
               on every rank, one captured decode step held to the plain
               version on every rank, tokens/s and peak memory per rank;
               then sharded_invariants in fp32 (TF32 off) at 1, 1 and 1
               layers: 4 ranks against one rank (apart from counted
               near-ties; moe: equal overflow counts), and on the dense
               model a preempt/spill/resume round trip and a mid-flight
               checkpoint restored into clone_fresh(), both against the
               solo run, and an unsharded engine refusing that
               checkpoint; then seq_cut in the same 4 processes on a
               (2, 2) mesh: make_prefill_step then 16 greedy
               make_serve_step steps (granite, qwen3-moe under ep: 2) on
               a contiguous cache of 2048 positions cut by the
               reference's rule, granite-20b under baseline (its
               positions over "model", FSDP over "data"), qwen1.5-4b
               under infer-tp and qwen3-moe under infer-tp2 and under ep
               (its experts 32 a rank over both axes, each MoE layer's
               tokens exchanged with their owners over "data"), each at
               1 layer in bf16 (8 x 1024 prompts) and in
               fp32 (8 x 128, 1 step) against
               rank 0's one-rank run: the tokens of ranks holding the
               same rows identical, decode launches = layers x steps and
               flash = layers on every rank, each rank's cache bytes the
               rule's, the last bf16 step's decode launches held to the
               plain version on every rank (with the lse at the decode
               phase's timed shapes where the positions are cut), the
               fp32 logits within 1e-4; then the hybrid, audio and vlm
               families the same way, with their side inputs cut on
               their rows: zamba2-7b at 7 layers under infer-tp (its
               Mamba2 blocks cut on whole heads, 56 of 112 a rank, SSD
               launched on each rank's heads; 8 x 512), whisper-tiny
               uncut under baseline (its self cache and its 1500-frame
               cross cache cut on their positions, 750 frames a rank,
               the cross decode merged from the kernel's lse; 8 x 64)
               and qwen2-vl-2b at 2 layers under infer-tp (M-RoPE
               decode over a cache cut on its positions; 8 x (256
               patches + 256)), each decode step's collectives by axis
               and kind, its launches and the cache bytes as the
               dry-run predicts
  sharded_train
               make_train_step(mesh=...) on the same 4 processes as a (2, 2)
               (data, model) mesh under the reference's baseline preset
               (tensor parallel over "model", FSDP and the batch over
               "data"; again one card time-sliced, not a parallel speed):
               4 bf16 steps of train_smollm's 8 x 256 TokenStream batches
               of qwen1.5-4b's widths at 2 layers (10/10 heads a rank) and
               qwen3-moe's at 1 (64 experts a rank), each beside rank 0's
               one-rank run of the same params in bf16: every rank's
               metrics identical, the loss falling and within 8 x bf16's
               own error (one rank's bf16 loss against the fp32 loss of
               its params) of one rank's, flash exactly layers x steps
               x 2 launches on every rank, each rank's param and moment
               bytes equal to the rule's, collectives a step by axis, MoE
               drops, peak memory, model FLOPs a token; then one fp32 step
               (TF32 off) at 2 and 1 layers against one rank's: every
               param and moment within its tolerance, equal drops; then
               the same checks on 1 bf16 step (held to the baseline's
               one-rank step) and one fp32 step of qwen3-moe under ep
               (the tokens exchanged with the experts' owners over
               "data") and dp (over "model"), and of qwen1.5-4b under
               infer-tp and infer-tp2; each step's collectives by axis
               and kind, count and bytes, all-to-all among them, equal
               to the dry-run's (ep's in the dryrun phase); then 2 bf16
               steps and the fp32 step under baseline of zamba2-7b at 7
               layers (a unit of 6 Mamba2 blocks cut on whole heads and
               the shared block, then a tail block: 14 SSD and 2 flash
               launches a step on every rank, the Mamba2 norm's
               all-reduce among the collectives), whisper-tiny uncut and
               qwen2-vl-2b at 2 layers, with their side inputs: each
               step's collectives by axis and kind, the launches and the
               slices' bytes equal to the dry-run's
Before moe_serve every earlier model and engine is freed; a "free" line
after each model gives the allocated and peak bytes.
The paged kernel's beyond line also holds it to its plain version on
block tables after prefix-cache hits (shared leading pages, one forked
page) and copy_paged_pages on the card bit-exact against the cpu.
Each serve phase (and eo_scene) zeroes the kernels' launch counters just
before it and reads them just after, and checks them against the path's
prefills and decode steps (zamba2-7b: 81 SSD scans and 13 flash launches
per prefill, 13 decode launches per decode step; eo_scene: one gate per
pass and one int8 per pass with escalations; space_ground: as above;
shared_prefix, speculative and constellation: one paged launch a layer
and decode step of every engine; moe_serve and mla_serve: as above).

Any failed check raises, so the script exits non-zero.  Without a GPU (or
without the rest of the repository beside it) it fails before printing any
result.  Its last two lines are the kernels' JSON record (with each
kernel's launches on moe_serve, mla_serve, dense_configs_serve,
xlstm_serve, train_families, whisper_serve, qwen2_vl_serve,
train_audio_vlm, sharded_serve and sharded_train (all ranks), flash's
and the gate's
on the training phases, and its
timed cases at their shapes) and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_T0 = time.perf_counter()

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA's data sheet) at its 700 W
# limit, kept with the port's other H100 constants: HBM, fp32 on the
# CUDA cores (exact fp32 math), bf16 on the tensor cores (dense)
from repro_torch.launch.mesh import (BF16_FLOP_PER_S,  # noqa: E402
                                     FP32_FLOP_PER_S, HBM_BYTES_PER_S)
PAGE = 16
# B,H,Hkv,D: smollm-360m's, two odd shapes, qwen3-moe-30b-a3b's (moe_serve),
# then one rank's of a 4-rank mesh (sharded_serve): qwen1.5-4b's 20/20
# heads of 128 and qwen3-moe's 32/4
PAGED_SHAPES = [(8, 15, 5, 64), (8, 8, 4, 48), (4, 3, 1, 80),
                (8, 32, 4, 128), (8, 5, 5, 128), (8, 8, 1, 128)]
# the LM gate (smollm's vocab), then the EO gate's 8 classes: a whole
# pass of eo_scene's tiles (the most a pass could send the gate) and an
# odd count; then the largest pass eo_scene's gate gets (its filter
# survivors, 365-605 rows; that phase holds each of those launches'
# inputs against the plain version too) and a 151936-wide vocab (the
# largest the reference's gate is sized for, and qwen3-moe's: moe_serve
# gates at it), these two in fp32 and bf16; the tiansuan pair's vocab at
# one row, the call space_ground makes for each finished satellite
# sequence; and deepseek-v3's vocab (mla_serve's gate): (B, V, dtypes)
GATE_SHAPES = [(1, 49152, ("float32",)), (8, 49152, ("float32",)),
               (8, 512, ("float32",)), (4096, 8, ("float32",)),
               (37, 8, ("float32",)), (605, 8, ("float32", "bfloat16")),
               (1, 151936, ("float32", "bfloat16")), (1, 512, ("float32",)),
               (1, 129280, ("float32", "bfloat16"))]
# (B, S, H, Hkv, D): the fixed-slot prefill and decode of smollm-360m at
# 8 x 1024 / a 2048-position cache first, then two odd shapes, then
# zamba2-7b's shared attention in hybrid_fixed_serve (4 x 512 prompts, a
# 1024-position cache), decode also at qwen3-moe's heads (moe_serve's
# fixed-slot decode); flash also at lengths shorter than one 64-key
# tile and one past it, at g = 3 and at D = 112, and at the head sizes
# the bf16 kernel takes that no config uses (16, 32, 96, 128); then
# granite-20b/34b's prefill (48 query heads over one KV head of 128:
# the group cut into 6 slices of 8 heads; dense_configs_serve, timed),
# ragged, a group of 12 (slices of 6) and qwen1.5-4b's 20/20 heads of
# 128 (dense_configs_serve).  The last: zamba2's shared block on a rank
# of seq_cut's (2, 2) mesh (4 x 512, 16/16 of its 32/32 heads)
FLASH_SHAPES = [(8, 1024, 15, 5, 64), (2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                (4, 512, 32, 32, 112), (2, 1, 15, 5, 64), (2, 17, 15, 5, 64),
                (2, 65, 15, 5, 64), (2, 1, 8, 8, 112), (2, 17, 8, 8, 112),
                (2, 65, 8, 8, 112), (2, 130, 6, 2, 16), (2, 150, 4, 1, 32),
                (2, 120, 8, 4, 96), (2, 200, 4, 2, 128),
                (4, 512, 48, 1, 128), (2, 333, 48, 1, 128),
                (2, 200, 12, 1, 64), (4, 512, 20, 20, 128),
                (4, 512, 16, 16, 112)]
# (B, S, H, Hkv, D): flash where the training phases launch it, in the
# same loop (out, lse and the autograd Function's gradients): smollm-360m
# in train_smollm (8 x 256), the tiansuan pair's ONBOARD (4/2 heads) and
# GROUND (8/4) at D = 48 in lm_cascade's training (8 x 96) and in its
# cascade forwards (the 95-token prefixes; GROUND's batch is the
# escalated items, at most 8); zamba2-7b's shared attention in
# train_families (8 x 256, 32/32 heads of 112); in train_audio_vlm,
# whisper-tiny's decoder self-attention (8 x 128, 6/6 heads of 64) and
# qwen2-vl-2b's (8 x (256 patches + 128 text), 12/2 heads of 128); in
# sharded_train one rank's rows and heads of a (2, 2) mesh: qwen1.5-4b's
# (4 x 256, 10/10 of its 20/20 heads of 128; baseline, infer-tp) and
# qwen3-moe's (4 x 256, 16/2 of its 32/4; baseline, ep), qwen3-moe's
# under dp (2 x 256, every head) and qwen1.5-4b's under infer-tp2 (the
# whole 8 x 256, 5/5 heads); zamba2-7b's shared block on a rank of
# sharded_train (4 x 256, 16/16 of its 32/32 heads of 112)
FLASH_TRAIN_SHAPES = [(8, 256, 15, 5, 64), (8, 96, 4, 2, 48),
                      (8, 96, 8, 4, 48), (8, 95, 4, 2, 48), (8, 95, 8, 4, 48),
                      (8, 256, 32, 32, 112), (8, 128, 6, 6, 64),
                      (8, 384, 12, 2, 128), (4, 256, 10, 10, 128),
                      (4, 256, 16, 2, 128), (2, 256, 32, 4, 128),
                      (8, 256, 5, 5, 128), (4, 256, 16, 16, 112)]
FLASH_TIMED_MIN_S = 128            # shorter shapes time only the launch
FLASH_MASKS = [(True, 0), (False, 0), (True, 64)]              # causal, window
# flash at a query length other than the key length, and whisper's and
# qwen2-vl's own prefill shapes: (B, Sq, Skv, H, Hkv, D, Dv, masks, the
# mask timed or None).  whisper-tiny's cross-attention in whisper_serve
# (8 prompts of 64 tokens against 1500 frames, 6/6 heads of 64,
# non-causal) and its encoder (8 x 1500, non-causal), both timed beside
# SDPA; qwen2-vl-2b's prefill in qwen2_vl_serve (4 x (256 patches + 256
# text), 12/2 heads of 128, causal), timed; whisper-tiny's
# cross-attention in train_audio_vlm (8 x 128 text tokens against 1500
# frames, non-causal), timed; then a causal pair each way at an odd
# group, against the plain version (windows only at Sq < Skv: at
# Sq > Skv a window leaves rows with no key, which the wrapper refuses).
# The encoder's (8, 1500) is also train_audio_vlm's
FLASH_SQ_SKV = [(8, 64, 1500, 6, 6, 64, 64, [(False, 0), (True, 0)],
                 (False, 0)),
                (8, 128, 1500, 6, 6, 64, 64, [(False, 0), (True, 0)],
                 (False, 0)),
                (8, 1500, 1500, 6, 6, 64, 64, [(False, 0), (True, 0)],
                 (False, 0)),
                (4, 512, 512, 12, 2, 128, 128, FLASH_MASKS, (True, 0)),
                (2, 200, 333, 4, 2, 64, 64, FLASH_MASKS, None),
                (2, 333, 200, 4, 2, 64, 64, [(True, 0), (False, 0)], None)]
DECODE_SHAPES = [(8, 2048, 15, 5, 64), (2, 200, 8, 4, 48), (2, 333, 3, 1, 80),
                 (4, 1024, 32, 32, 112), (8, 2048, 32, 4, 128)]
# the contiguous decode kernel on whisper_serve's and qwen2_vl_serve's
# paths: whisper-tiny's cross-attention decode over all 1500 frames of
# its static cache (6/6 heads of 64, every kv_len 1500; its self decode
# is the same heads on a 448-position cache), and qwen2-vl-2b's decode
# (12/2 heads of 128, a 1024-position cache): ((B, S, H, Hkv, D), kv_len
# or None for KV_LENS)
DECODE_SIDE = [((8, 1500, 6, 6, 64), [1500] * 8),
               ((4, 1024, 12, 2, 128), None)]
# (B, S, H, Hkv, D, Dv): flash at split head dims, deepseek-v3's expanded
# MLA prefill (q/k 192 = 128 nope + 64 rope, v 128, 128/128 heads)
FLASH_SPLIT_SHAPES = [(2, 1024, 128, 128, 192, 128)]
# (B, S, H, P, N, G, chunk, strong decay, views): zamba2-7b's prefill in
# hybrid_fixed_serve (4 x 512 tokens, two chunks) and its longest
# continuous admission (768 tokens, three chunks), with x, B and C cut
# as views from one (B, S, H*P + 2*G*N) tensor as mamba2_fwd cuts them
# (B/C at group level, G = 1); then zamba2's widths at 512 tokens on
# contiguous tensors, the reduced config's widths, a prompt shorter than
# the chunk, N = 128 over three chunks, a decay (A = -16, dt ~ 6) whose
# unmasked exp would overflow, and P = 128 with N = 64 and N = 128 (the
# bf16 kernel's wide register tiles; no config uses them).  The last
# two: a rank's heads on the mesh (56 of 112 over "model", its rows of
# 8 over "data", x, B and C views of the rank's xbc), in seq_cut's
# prefill (4 x 512) and in sharded_train (4 x 256)
SSM_SHAPES = [(4, 512, 112, 64, 64, 1, 256, False, True),
              (1, 768, 112, 64, 64, 1, 256, False, True),
              (1, 512, 112, 64, 64, 1, 256, False, False),
              (2, 128, 8, 32, 16, 8, 64, False, False),
              (1, 200, 5, 48, 16, 5, 256, False, False),
              (2, 768, 8, 64, 128, 2, 256, False, False),
              (2, 256, 4, 32, 16, 4, 64, True, False),
              (1, 256, 4, 128, 64, 1, 256, False, True),
              (1, 384, 4, 128, 128, 2, 128, False, False),
              (4, 512, 56, 64, 64, 1, 256, False, True),
              (4, 256, 56, 64, 64, 1, 256, False, True)]
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
KV_LENS = [1, 2048, 37, 1000, 511, 16, 1999, 260]
# Both decode kernels beyond the main paths, timed: granite-20b/34b's 48
# query heads over one KV head at D = 128 on smollm's lengths, and a
# cache of 8192 positions (each CTA of a cluster loops over tiles):
# (name, (H, Hkv, D), lengths, positions in the cache)
DECODE_WIDE = [("granite_group", (48, 1, 128), KV_LENS, 2048),
               ("cache_8192", (15, 5, 64),
                [8192, 8191, 4097, 1, 777, 8000, 3, 6000], 8192)]
DECODE_REPEATS = 20                # launches that must repeat the first's bits
# the contiguous kernel with the lse at the shapes seq_cut's ranks run it
# at (its (2, 2) mesh cuts the 8 rows over "data" and the 2048 positions
# over "model"): granite-20b's slice (4 rows, 1024 positions, 48/1 heads
# of 128: under baseline the one KV head keeps the heads whole) and
# qwen1.5-4b's under infer-tp (20/20 heads of 128, the cache holding every
# head) and qwen3-moe's under ep (32/4, its 4 KV heads whole in the
# cache: they do not divide 16); then whisper-tiny's self-attention slice
# under baseline (448 positions, 224 a rank, its 6/6 heads of 64 gathered
# on every rank) and its cross slice (750 of the 1500 frames: every one
# valid on its path), and qwen2-vl-2b's under infer-tp (256 patches + 1024 positions,
# 640 a rank, 12/2 heads of 128); lengths a rank holds, one row with none
# of its sequence's positions (out 0, lse -1e30).  seq_cut checks that its
# launches ran at these shapes.
DECODE_LSE = (((4, 1024, 48, 1, 128), [1024, 0, 16, 1]),
              ((4, 1024, 20, 20, 128), [1024, 0, 512, 3]),
              ((4, 1024, 32, 4, 128), [1024, 0, 700, 5]),
              ((4, 224, 6, 6, 64), [68, 0, 30, 224]),
              ((4, 750, 6, 6, 64), [750, 0, 750, 750]),
              ((4, 640, 12, 2, 128), [640, 0, 333, 1]))
# the paged kernel at the tiansuan pair's heads (ONBOARD 4/2, GROUND 8/4,
# D = 48; page size 16) over space_ground's lengths (prompts of 8-40 and
# up to 32 new tokens), and one sequence of 138 positions (speculative's
# one-slot draft engine at its longest; the kernel's largest cluster),
# timed: (name, (H, Hkv, D), lengths)
TIANSUAN_PAGED = [("tiansuan_onboard", (4, 2, 48),
                   [1, 8, 16, 17, 40, 47, 64, 71]),
                  ("tiansuan_ground", (8, 4, 48),
                   [1, 8, 16, 17, 40, 47, 64, 71]),
                  ("tiansuan_onboard_one", (4, 2, 48), [138]),
                  ("tiansuan_ground_one", (8, 4, 48), [138])]
# the decode step (0-based) each serve phase keeps for _decode_checks: a
# warm one, every slot of full_serve busy
CAPTURE_STEP = 16
DECODE_KERNELS = ("paged_decode_attention", "decode_attention")
PAGED_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
# flash's lse (fp32 on both sides, from the same operands with fp32
# sums) in both types: atol, rtol.  Set from the readings on an H100 80GB
# HBM3 at 700.00 W: every case within 2.6e-6 of the plain version
# (the largest at MLA's 192/128 in bf16), lse values ~0-10
LSE_TOL = (1e-5, 1e-5)
# flash's bf16 gradients against fp32 autograd: at most this many times
# the error of the same flash backward on the plain forward's bf16 out
# and lse (``_flash_grad_share``)
BF16_GRAD_FACTOR = 2.0
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
# shared_prefix: smollm-360m's widths at SP_LAYERS layers in fp32 (uncut
# until sharded_train needed the smoke's time), SP_REQUESTS requests at
# SP_RATE
# a step over SP_HEADERS system headers of SP_HEADER_PAGES pages of 16
# (256 tokens) plus a unique tail, and one planted request that is exactly
# header 0 (a copy-on-write); 8 slots, max_seq 512, the default pool
SP_REQUESTS, SP_HEADERS, SP_HEADER_PAGES = 32, 4, 16
SP_TAIL, SP_MAX_NEW, SP_RATE, SP_SEED = (8, 64), (16, 32), 0.6, 11
SP_SLOTS, SP_MAX_SEQ = 8, 512
SP_LAYERS = 8                      # 16 until seq_cut needed the time
# speculative: the tiansuan GROUND tier in fp32, k = draft_k = 8, SPEC_N
# prompts of 32-64 tokens, max_new 64
SPEC_K, SPEC_N, SPEC_PROMPTS, SPEC_MAX_NEW, SPEC_SEED = 8, 4, (32, 64), 64, 13
# constellation: configs/tiansuan_constellation.py's CONSTELLATION with
# 8-slot ONBOARD engines (max_seq 128, pages of 16, the default pool, a
# prefill budget of 16), CN_REQUESTS requests (prompts 8-40, max_new
# 16-32) one a tick, every third at priority 1, all via satellite 0; the
# faulted run takes the reference bench's constellation fault plan
# (benchmarks/serving_throughput.py CN_FRAME_* and CN_*_CORRUPT*)
CN_REQUESTS, CN_PROMPTS, CN_MAX_NEW, CN_SEED = 24, (8, 40), (16, 32), 9
CN_SLOTS, CN_MAX_SEQ, CN_BUDGET = 8, 128, 16
CN_FAULTS = dict(seed=11, frame_loss_rate=0.2, frame_corrupt_rate=0.15,
                 spill_corrupt_every=3)
CN_FAULT_FRAME, CN_FAULT_RETRIES = 256, 6
# moe_serve and mla_serve: MOE_REQUESTS Poisson arrivals (MOE_RATE a step,
# prompts and max_new in the given ranges) through the paged engine
# (MOE_SLOTS slots, max_seq MOE_MAX_SEQ, the default prefill budget), then
# ServingEngine.generate on MOE_FIXED (batch, prompt length, new tokens);
# the held rerun serves MOE_HELD_REQUESTS of the arrivals and generates
# MOE_HELD_NEW tokens.  deepseek-v3 runs at its published widths with
# MLA_LAYERS layers (the three dense-MLP layers and one MoE layer)
MOE_REQUESTS, MOE_PROMPTS, MOE_MAX_NEW, MOE_RATE = 16, (32, 192), (16, 32), 0.5
MOE_SEED, MOE_SLOTS, MOE_MAX_SEQ, MOE_FIXED = 21, 8, 512, (4, 128, 16)
MOE_HELD_REQUESTS, MOE_HELD_NEW = 2, 4
MOE_TRAFFIC = dict(requests=MOE_REQUESTS, prompts=MOE_PROMPTS,
                   max_new=MOE_MAX_NEW, rate=MOE_RATE, seed=MOE_SEED,
                   slots=MOE_SLOTS, max_seq=MOE_MAX_SEQ, fixed=MOE_FIXED,
                   held_requests=MOE_HELD_REQUESTS, held_new=MOE_HELD_NEW)
MLA_LAYERS = 4
# qwen3-moe in moe_serve at its widths cut to MOE_SERVE_LAYERS (uncut, 48,
# until sharded_train needed the smoke's time: 69-91 s of it; 24 until
# sharded_serve's seq_cut did)
MOE_SERVE_LAYERS = 8
# their fp32 invariants (TF32 off): qwen3-moe's widths at MOE_INV_LAYERS
# layers, deepseek-v3's at MLA_LAYERS; INV_REQUESTS arrivals a step
# apart, a fixed batch of 4 x INV_FIXED_LEN
MOE_INV_LAYERS = 4
INV_REQUESTS, INV_PROMPTS, INV_MAX_NEW = 4, (16, 96), (6, 10)
INV_FIXED_LEN = 48
# train_smollm: launch/train.py's loop (training/loop.py::train) on
# smollm-360m at full width in bf16, on the TokenStream (seed 0), remat
# on: TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, lr TRAIN_LR
# with TRAIN_WARMUP warmup steps, every step logged
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 20, 8, 256
TRAIN_LR, TRAIN_WARMUP = 1e-3, 10
# train_step: one make_train_step step at smollm-360m's full widths cut
# to TRAIN_CHECK_LAYERS layers, on train_smollm's first batch, lr
# TRAIN_LR with no warmup, through the kernel's path (fp32 and bf16) and
# the plain path (fp32), TF32 off.  The kernel's step against the plain
# one, in its type: (loss rtol, largest relative L2 error of a leaf of
# the first AdamW moment, i.e. of the clipped gradient, largest relative
# L2 error of the update new - old: of a leaf in fp32, of all leaves at
# once in bf16).  Set from the readings on an H100 80GB HBM3 at 700.00 W:
# fp32 0, 2.6e-5 (embed), 3.0e-4; bf16 4.9e-6, 0.015 (w_k), 0.080.  A
# step that drops the update errs 1.0 there, one with its sign flipped
# 2.0
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_TOL = {torch.float32: (1e-5, 1e-3, 3e-3),
                   torch.bfloat16: (1e-4, 5e-2, 2e-1)}
# lm_cascade: tests/test_lm_cascade.py on the card: the tiansuan pair
# trained (ONBOARD LM_STEPS["onboard"] steps, GROUND LM_STEPS["ground"]),
# the gate calibrated to LM_BUDGET on the held-out batch LM_EVAL_STEP, the
# collaborative and onboard-only cascades
LM_SEQ, LM_BATCH, LM_LR, LM_WARMUP = 96, 8, 2e-3, 5
LM_STEPS = {"onboard": 30, "ground": 90}
LM_BUDGET, LM_EVAL_STEP = 0.6, 10_000
# the JAX package's figures for the same test on the host CPU
# (scripts/lm_cascade_reference.py; its own params, drawn from the JAX
# PRNG, so its accuracies are a yardstick, not a target)
LM_CASCADE_REFERENCE = dict(
    onboard_losses=[6.289071559906006, 5.8457417488098145],
    ground_losses=[6.309732437133789, 4.256168842315674],
    threshold=0.01013067178428173, acc_collaborative=0.125,
    acc_onboard_only=0.0, escalated=4, escalation_rate=0.5,
    bytes_downlinked=1584.0, bytes_bentpipe_baseline=3040.0)
# a CPU rehearsal of the last five phases (device="cpu") sets this: their
# models then run at one layer (counts follow from lengths and arrivals,
# not depth), and the moe family's at its reduced config (its widths do
# not fit a host); the card's run leaves it False
REHEARSAL = False
# each kernel phase's rows, for the kernels line's cases on the moe and
# MLA paths: the kernels' shapes there, and the keys each case keeps
ROWS = {}
FAMILY_SHAPES = {"paged_decode_attention": [[8, 32, 4, 128],
                                            [8, 5, 5, 128], [8, 8, 1, 128]],
                 "decode_attention": [[8, 2048, 32, 4, 128],
                                      [8, 1500, 6, 6, 64],
                                      [4, 1024, 12, 2, 128],
                                      [8, 1024, 48, 1, 128],
                                      [4, 750, 6, 6, 64],
                                      [4, 640, 12, 2, 128]],
                 "ssm_chunk_scan": [[4, 512, 56, 64, 64],
                                    [4, 256, 56, 64, 64]],
                 "flash_attention": [[2, 1024, 128, 128, 192, 128],
                                     [4, 512, 48, 1, 128],
                                     [8, 256, 32, 32, 112],
                                     [8, 64, 6, 6, 64], [8, 1500, 6, 6, 64],
                                     [4, 512, 12, 2, 128],
                                     [8, 128, 6, 6, 64],
                                     [8, 384, 12, 2, 128],
                                     [4, 256, 10, 10, 128],
                                     [4, 256, 16, 2, 128],
                                     [4, 512, 16, 16, 112]],
                 "confidence_gate": [[1, 151936], [1, 129280]]}
CASE_KEYS = ("shape", "Skv", "causal", "dtype", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_error", "lse")


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - _T0}), flush=True)


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
    behind a spin kernel that outlasts the host's time to queue them all
    (``_spin_cycles``), so the device runs them back to back and the
    events hold device time only, not the host's time to launch."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _flush_buf.fill_(1)
    fn()
    host_s = time.perf_counter() - t0      # one call queued, the card idle
    torch.cuda.synchronize()
    torch.cuda._sleep(_spin_cycles(host_s, iters))
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


# the spin before time_ms's calls, in cycles: 4 x the host's time to
# queue them at a 1 GHz floor of the card's clock (an H100 runs at
# ~1.7-2 GHz), at least ~10 ms and at most ~0.2 s at 2 GHz, the fixed
# spin of every call until the smoke's time ran short
SPIN_CYCLES = (20_000_000, 400_000_000)


def _spin_cycles(host_s: float, iters: int) -> int:
    lo, hi = SPIN_CYCLES
    return int(min(hi, max(lo, 4 * iters * host_s * 1e9)))


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


def _bound_of(work: dict) -> tuple:
    """``bound_ms`` of a kernel wrapper's ``work()``: its operations at
    the tensor cores' bf16 rate where it runs on them, else the CUDA
    cores' fp32 rate."""
    return bound_ms(work["bytes"], work["flops"],
                    BF16_FLOP_PER_S if work["tensor_cores"]
                    else FP32_FLOP_PER_S)


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
    operations at the peak rate of q's type (the wrappers' ``work()``)."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import paged_decode_attention as KP
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
    lens = [int(n) for n in lens]
    if len(args) == 5:                       # paged: the table entries read
        w = KP.work(B, H, k.shape[2], D, lens, q.dtype, k.shape[1])
    else:
        w = KD.work(B, H, k.shape[2], D, lens, q.dtype)
    b_ms, b_by = _bound_of(w)
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
    ROWS["paged_decode_attention"] = rows
    emit("paged_decode_attention", cases=rows)
    _paged_beyond(K, ref, gen)
    return main


def _paged_beyond(K, ref, gen) -> None:
    """The paged kernel beyond the main path's shapes: granite's group
    and an 8192-position cache (timed), the tiansuan heads (timed), one
    sequence at the tiansuan heads over every length of the speculative
    draft engine's table, the tile and cluster edges at page sizes 16
    and 128, a page outside the pool, repeated bits."""
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
    single = []
    for H, Hkv, D in sorted({heads for _, heads, _ in TIANSUAN_PAGED}):
        for dtype in (torch.bfloat16, torch.float32):
            shares = []
            for n in TI.SINGLE_LENS:
                args = [torch.from_numpy(a).cuda() for a in
                        TI.paged_lengths_inputs([n], H, Hkv, D, PAGE, seed=n,
                                                max_pages=TI.SINGLE_PAGES)]
                args[:3] = [a.to(dtype) for a in args[:3]]
                got = K.paged_decode_attention_kernel(*args)
                shares.append(_share_of_tolerance(
                    got, ref.paged_decode_attention_ref(*args),
                    *PAGED_TOL[dtype]))
                check(bool(torch.isfinite(got).all()) and shares[-1] <= 1.0,
                      f"paged one sequence {H, Hkv, D} {dtype} kv_len {n}: "
                      f"share {shares[-1]}")
            single.append(dict(heads=[H, Hkv, D], dtype=str(dtype)[6:],
                               kv_len=TI.SINGLE_LENS,
                               table_pages=TI.SINGLE_PAGES, cut=K.plan(
                                   1, H, Hkv, D, PAGE, TI.SINGLE_PAGES,
                                   dtype),
                               max_share_of_tolerance=max(shares)))
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
    shared = _paged_shared_tables(K, ref, TI)
    emit("paged_decode_attention_beyond", wide=wide, tiansuan=tiansuan,
         one_sequence=single, edges=edges, shared_tables=shared,
         bad_page_only_its_sequence_nan=bad_ok,
         repeats_bits_over=DECODE_REPEATS, repeats=repeats)


def _paged_shared_tables(K, ref, TI) -> dict:
    """The paged kernel on block tables after prefix-cache hits (rows
    naming the same physical pages, one forked page, runs of 4 and 16
    pages; tests/torch_inputs.py) at smollm's and the tiansuan ONBOARD tier's heads, each held to its
    plain version, and copy_paged_pages (the copy-on-write page copy) on
    a CUDA pool bit-exact against the same copy on the CPU."""
    from repro_torch.models.transformer import copy_paged_pages
    cases = []
    for (run, lens), (H, Hkv, D) in itertools.product(TI.SHARED_CASES,
                                                      TI.SHARED_HEADS):
        for dtype in (torch.bfloat16, torch.float32):
            args = [torch.from_numpy(a).cuda() for a in
                    TI.shared_paged_inputs(lens, H, Hkv, D, PAGE, run,
                                           seed=H)]
            args[:3] = [a.to(dtype) for a in args[:3]]
            got = K.paged_decode_attention_kernel(*args)
            want = ref.paged_decode_attention_ref(*args)
            atol, rtol = PAGED_TOL[dtype]
            err, excess = _max_excess(got, want, atol, rtol)
            check(bool(torch.isfinite(got).all()) and excess <= 0,
                  f"paged on shared tables {H, Hkv, D} {dtype} run {run}: "
                  f"max_abs_err {err}")
            cases.append(dict(heads=[H, Hkv, D], dtype=str(dtype)[6:],
                              kv_len=lens, shared_run=run,
                              max_abs_err=err, share_of_tolerance=
                              _share_of_tolerance(got, want, atol, rtol)))
    gen = torch.Generator().manual_seed(3)
    copies = {}
    for dtype in (torch.float32, torch.bfloat16):
        host = {"blocks": {k: torch.randn((32, 9, PAGE, 5, 64),
                                          generator=gen).to(dtype)
                           for k in ("k", "v")}}
        card = {"blocks": {k: t.cuda() for k, t in host["blocks"].items()}}
        for cache in (host, card):
            copy_paged_pages(cache, [2, 5, 7], [8, 1, 3])
        copies[str(dtype)[6:]] = all(
            torch.equal(card["blocks"][k].cpu().view(torch.uint8),
                        host["blocks"][k].view(torch.uint8))
            for k in ("k", "v"))
    check(all(copies.values()), f"copy_paged_pages on the card differs "
          f"from the cpu {copies}")
    return dict(cases=cases, copy_paged_pages_bit_exact=copies)


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


def _graph_nodes(fn, what: str) -> list:
    """The node types of a CUDA graph captured from one call of ``fn``,
    read through libcuda (``cuGraphGetNodes``, ``cuGraphNodeGetType``:
    0 is a kernel): every launch the call makes, counted exactly, where
    a profiler window can drop records.  Fails unless the call
    launches one kernel and nothing else."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
          f"{what}: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
          f"{what}: cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(t)) == 0,
              f"{what}: cuGraphNodeGetType failed")
        types.append(t.value)
    g.reset()
    check(types == [0], f"{what}: one call launched graph nodes of types "
          f"{types} (want one kernel, 0)")
    return types


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
            b_ms, b_by = _bound_of(K.work(B, V, x.dtype))
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
    ROWS["confidence_gate"] = rows
    emit("confidence_gate", cases=rows, launch_floor_ms=launch_floor_ms(),
         profiled_main_call_us=profiled)
    return main


def _flash_grad_share(q, k, v, kw, gen, atol, rtol) -> dict:
    """dq, dk, dv of ``FlashAttention`` (the kernel's forward with its lse,
    the plain backward) for one dO drawn from ``gen``, against autograd
    through the plain ``flash_attention_ref`` on fp32 copies of the
    inputs.  fp32: within atol + rtol |want|.  bf16: the reference's
    backward (``repro/models/flash.py``) takes delta = rowsum(dO * out)
    from the out it returns in the input's type, so its bf16 gradients
    carry out's rounding and sit several such tolerances from fp32
    autograd (ROADMAP Queue 3); there the error may be at most
    BF16_GRAD_FACTOR times that of the same backward on the plain
    forward's bf16 out and lse, plus atol.  fp32 at a GQA group above
    8 (the sliced groups): at most atol + rtol times each gradient's
    largest entry.  There one KV head's dk and dv sum g x S query rows,
    and the lse's own fp32 error (within LSE_TOL) scales each row's
    probabilities, so the error grows with the terms summed, not with
    the entry (granite's (4, 512, 48/1, 128): 1.9e-4 where dv reaches
    ~32, on an H100 80GB HBM3 at 700.00 W).  Returns the worst share of
    the bound (checked <= 1) and the errors."""
    from repro_torch.kernels import ref
    from repro_torch.models.flash import FlashAttention, flash_bwd
    do = torch.randn((*q.shape[:3], v.shape[-1]), generator=gen).to(
        "cuda", q.dtype)
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(
        FlashAttention.apply(*xs, kw["causal"], kw["window"]), xs, do)
    xf = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*xf, **kw), xf,
                               do.float())
    torch.cuda.synchronize()
    for g in got:
        check(bool(torch.isfinite(g).all()), "flash backward: non-finite")
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
    row = dict(grad_max_abs_err=max(errs))
    if q.dtype == torch.float32 and q.shape[2] // k.shape[2] > 8:
        row["grad_share_of_tolerance"] = max(
            e / (atol + rtol * float(w.abs().max()))
            for e, w in zip(errs, want))
        row["grad_bound"] = "atol + rtol * max|grad|"
        return row
    if q.dtype == torch.float32:
        row["grad_share_of_tolerance"] = max(
            _share_of_tolerance(g, w, atol, rtol) for g, w in zip(got, want))
        return row
    with torch.no_grad():
        out_p, lse_p = ref.flash_attention_ref(q, k, v, **kw,
                                               return_lse=True)
        plain = flash_bwd(q, k, v, out_p, lse_p, do, **kw)
    plain_errs = [float((p.float() - w).abs().max())
                  for p, w in zip(plain, want)]
    row.update(grad_plain_bf16_max_abs_err=max(plain_errs),
               grad_share_of_tolerance=max(
                   e / (BF16_GRAD_FACTOR * pe + atol)
                   for e, pe in zip(errs, plain_errs)))
    return row


def phase_flash(ptxas: dict) -> dict:
    """The flash kernel against its plain version, causal, non-causal and
    windowed, in bf16 (tensor cores) and fp32 (CUDA cores), with the
    share of the tolerance each case uses; timed (with SDPA's time on
    pre-transposed inputs as the library yardstick) and its achieved
    TFLOP/s for the causal cases of S >= FLASH_TIMED_MIN_S and the
    FLASH_SQ_SKV cases at their timed mask (a ``Skv`` key in the rows
    whose key length differs from the query length).  Also prints
    the registers and spills ptxas reported for the bf16 kernel.  Every
    case also launches the kernel with its lse output: the same out bit
    for bit, the lse against the plain version's, and the autograd
    Function's dq, dk, dv against autograd through the plain version in
    fp32 (the worst share of the tolerance printed); the timed cases also
    time the forward with the lse and the plain backward."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    from repro_torch.models.flash import flash_bwd
    F = torch.nn.functional
    gen = torch.Generator().manual_seed(2)
    gen_do = torch.Generator().manual_seed(3)
    rows, main = [], None
    # (B, Sq, Skv, H, Hkv, D, Dv, masks, the timed mask or None)
    cases = [(B, S, S, H, Hkv, D, Dv, FLASH_MASKS, (True, 0)
              if S >= FLASH_TIMED_MIN_S else None)
             for B, S, H, Hkv, D, Dv in
             [(*s, s[-1]) for s in FLASH_SHAPES + FLASH_TRAIN_SHAPES]
             + FLASH_SPLIT_SHAPES] + FLASH_SQ_SKV
    for B, Sq, Skv, H, Hkv, D, Dv, masks, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Sq, H, D), generator=gen).to("cuda", dtype)
            k = torch.randn((B, Skv, Hkv, D), generator=gen).to("cuda", dtype)
            v = torch.randn((B, Skv, Hkv, Dv), generator=gen).to("cuda",
                                                                 dtype)
            atol, rtol = PAGED_TOL[dtype]
            for causal, window in masks:
                kw = dict(causal=causal, window=window)
                got = K.flash_attention_kernel(q, k, v, **kw)
                want = ref.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err, excess = _max_excess(got, want, atol, rtol)
                check(bool(torch.isfinite(got).all()), "flash: non-finite")
                check(excess <= 0, f"flash {B,Sq,Skv,H,Hkv,D,Dv} {dtype} "
                      f"{kw}: max_abs_err {err} over atol {atol} + rtol "
                      f"{rtol}")
                shape = [B, Sq, H, Hkv, D] + ([Dv] if Dv != D else [])
                row = dict(shape=shape, dtype=str(dtype)[6:],
                           **({"Skv": Skv} if Skv != Sq else {}),
                           causal=causal, window=window, max_abs_err=err,
                           atol=atol, rtol=rtol,
                           share_of_tolerance=_share_of_tolerance(
                               got, want, atol, rtol))
                got_l, lse = K.flash_attention_kernel(q, k, v, **kw,
                                                      return_lse=True)
                want_lse = ref.flash_attention_ref(q, k, v, **kw,
                                                   return_lse=True)[1]
                torch.cuda.synchronize()
                check(torch.equal(got_l, got), f"flash {shape} {dtype} "
                      f"{kw}: out with the lse differs from out without")
                lse_err, lse_excess = _max_excess(lse, want_lse, *LSE_TOL)
                check(lse_excess <= 0, f"flash {shape} {dtype} {kw}: lse "
                      f"max_abs_err {lse_err} over atol, rtol {LSE_TOL}")
                grads = _flash_grad_share(q, k, v, kw, gen_do, atol, rtol)
                check(grads["grad_share_of_tolerance"] <= 1.0,
                      f"flash backward {shape} {dtype} {kw}: {grads} of "
                      f"atol {atol} + rtol {rtol}")
                row.update(lse_max_abs_err=lse_err,
                           lse_share_of_tolerance=_share_of_tolerance(
                               lse, want_lse, *LSE_TOL), **grads)
                if (causal, window) == timed:
                    # q, k, v read and the output written once, each at
                    # its own head dim; QK^T and PV over the kept pairs
                    w = K.work(B, Sq, Skv, H, Hkv, D, Dv, dtype, **kw)
                    n_ops = w["flops"]
                    peak = (BF16_FLOP_PER_S if w["tensor_cores"]
                            else FP32_FLOP_PER_S)
                    b_ms, b_by = _bound_of(w)
                    qt, kt, vt = (t.transpose(1, 2).contiguous()
                                  for t in (q, k, v))
                    ms = time_ms(lambda: K.flash_attention_kernel(
                        q, k, v, **kw))
                    try:
                        library = time_ms(
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=causal,
                                enable_gqa=True))
                    except RuntimeError as e:    # no SDPA back end takes it
                        library = None
                        row["library_error"] = str(e)[:300]
                    do = torch.randn(got.shape, generator=gen_do).to(
                        "cuda", dtype)
                    row.update(
                        ms_lse=time_ms(lambda: K.flash_attention_kernel(
                            q, k, v, **kw, return_lse=True)),
                        plain_backward_ms=time_ms(lambda: flash_bwd(
                            q, k, v, got, lse, do, **kw), iters=10))
                    if library is not None:
                        # SDPA's backward alone (its graph kept): the
                        # yardstick of a CUDA flash backward
                        xs = [t.detach().requires_grad_(True)
                              for t in (qt, kt, vt)]
                        o = F.scaled_dot_product_attention(
                            *xs, is_causal=causal, enable_gqa=True)
                        dot = do.transpose(1, 2).contiguous()
                        row["library_backward_ms"] = time_ms(
                            lambda: torch.autograd.grad(o, xs, dot,
                                                        retain_graph=True),
                            iters=10)
                    row.update(
                        ms=ms, tflop_per_s=n_ops / ms / 1e9,
                        plain_ms=time_ms(lambda: ref.flash_attention_ref(
                            q, k, v, **kw), iters=10),
                        library_ms=library,
                        bound_ms=b_ms, bound_by=b_by,
                        bound_peak_flop_per_s=peak)
                    if (B, Sq, H, Hkv, D) == FLASH_SHAPES[0] \
                            and dtype == torch.bfloat16:
                        main = row
                rows.append(row)
    ROWS["flash_attention"] = rows
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
    for (B, S, H, Hkv, D), lens in ([(s, None) for s in DECODE_SHAPES]
                                    + DECODE_SIDE):
        for dtype in (torch.bfloat16, torch.float32):
            args = _decode_case(B, S, H, Hkv, D, dtype, gen, lens)
            row = _decode_row(K.decode_attention_kernel,
                              ref.decode_attention_ref, _sdpa_decode(*args),
                              args, [B, S, H, Hkv, D])
            row["kv_len"] = args[3].tolist()
            rows.append(row)
            if (B, S, H, Hkv, D) == DECODE_SHAPES[0] \
                    and dtype == torch.bfloat16:
                main = row
    ROWS["decode_attention"] = rows
    emit("decode_attention", cases=rows)
    rows.extend(_decode_lse(K, ref, gen))    # the kernels line's cases
    _decode_beyond(K, ref, gen)
    return main


def _decode_lse(K, ref, gen) -> list:
    """The kernel with ``return_lse`` at each DECODE_LSE shape in both
    types: out held to the plain version at PAGED_TOL and the lse at
    LSE_TOL, the row with no position exactly out 0 and lse -1e30, the
    out the same bits as without the lse; timed beside the plain version
    and SDPA over the same slice, with the bound of
    ``work(return_lse=True)``."""
    rows = []
    for ((B, S, H, Hkv, D), lens), dtype in itertools.product(
            DECODE_LSE, (torch.bfloat16, torch.float32)):
        args = _decode_case(B, S, H, Hkv, D, dtype, gen, lens=lens)
        o, lse = K.decode_attention_kernel(*args, return_lse=True)
        want_o, want_l = ref.decode_attention_ref(*args, return_lse=True)
        sync()
        atol, rtol = PAGED_TOL[dtype]
        err, excess = _max_excess(o, want_o, atol, rtol)
        l_err, l_excess = _max_excess(lse, want_l, *LSE_TOL)
        empty = [i for i, n in enumerate(lens) if n == 0]
        full = [i for i, n in enumerate(lens) if n > 0]
        what = f"decode lse {[B, S, H, Hkv, D]} {dtype}"
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse[full])
                   .all()), f"{what}: non-finite")
        check(excess <= 0 and l_excess <= 0, f"{what}: out err {err}, lse "
              f"err {l_err} over their tolerances")
        check(bool((o[empty] == 0).all() and (lse[empty] == -1e30).all()),
              f"{what}: a row with kv_len 0 gave out {o[empty].abs().max()}"
              f", lse {lse[empty].max()}")
        check(torch.equal(K.decode_attention_kernel(*args), o),
              f"{what}: out differs without the lse")
        b_ms, b_by = _bound_of(K.work(B, H, Hkv, D, lens, dtype,
                                      return_lse=True))
        library = _sdpa_decode(*args)
        rows.append(dict(
            shape=[B, S, H, Hkv, D], dtype=str(dtype)[6:], kv_len=lens,
            lse=True, max_abs_err=err, lse_max_abs_err=l_err, atol=atol,
            rtol=rtol, lse_tol=LSE_TOL,
            ms=time_ms(lambda: K.decode_attention_kernel(
                *args, return_lse=True)),
            ms_without_lse=time_ms(lambda: K.decode_attention_kernel(*args)),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(
                *args, return_lse=True)),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
            cut=K.plan(B, H, Hkv, D, S, dtype)))
    emit("decode_attention_lse", cases=rows)
    return rows


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


def phase_ssm_scan(ptxas: dict) -> dict:
    """The SSD chunked-scan kernel against its plain version (fp32 y and
    state from bf16 inputs on the tensor cores or fp32 inputs on the
    CUDA cores, no NaN), with the share of the tolerance each case uses,
    both timed and the kernel's achieved TFLOP/s (``ssm_scan.work`` over
    its time); no single PyTorch call computes the scan, so there is no
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
            x = args[0]
            w = K.work(B, S, H, P, N, G, chunk, dtype)
            peak = (BF16_FLOP_PER_S if w["tensor_cores"]
                    else FP32_FLOP_PER_S)
            work = w["flops"]
            b_ms, b_by = _bound_of(w)
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
    ROWS["ssm_chunk_scan"] = rows
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
    ``transformer.decode_step`` call (and, with ``chunks``, every
    ``transformer.prefill_chunk`` call) made while it is active (the
    engines call them through the module), and the bytes of the cache
    the first decode step is given: a serve phase's prefill time, time
    per decode step and cache size, read from its own run.  Read after a
    sync.  With ``capture_at``, the arguments of that decode step
    (0-based) are kept for ``_decode_checks``: the live cache, clones of
    the rest (a dense decode step run again on them writes the same K/V
    rows and reads the same positions)."""

    def __init__(self, capture_at: int = None, chunks: bool = False):
        self.capture_at = capture_at
        self.chunks = chunks
        self.captured = None

    def __enter__(self):
        from repro_torch.models import transformer as T
        self._T = T
        self._orig = (T.prefill, T.decode_step, T.prefill_chunk)
        self.events = {"prefill": [], "decode": [], "chunk": []}
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
        if self.chunks:
            T.prefill_chunk = timed(T.prefill_chunk, "chunk")
        return self

    def __exit__(self, *exc):
        T = self._T
        T.prefill, T.decode_step, T.prefill_chunk = self._orig

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
    counts and, under "readings", what the dryrun phase holds its
    decode-step prediction to."""
    from repro_torch.config import get_config
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("smollm-360m")
    B, S, max_new, max_seq = 8, 1024, 32, 2048
    eng = ServingEngine.init(cfg, seed=0, max_seq=max_seq, device=device)
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
    readings = dict(cfg=cfg, batch=B, cache_len=max_seq,
                    decode_step_ms=1e3 * sum(decode_s) / len(decode_s),
                    decode_per_step=counts["decode_attention"] / max_new,
                    kv_cache_bytes=steps.cache_bytes)
    return dict(counts, readings=readings)


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
        b_ms, b_by = _bound_of(K.work(N, D, x.dtype))
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


# --------------------------------------------------------------------------
# shared-prefix serving, draft-verify and the constellation
# --------------------------------------------------------------------------

def _exact_or_near_ties(name, runs, want, prompts, params, cfg) -> dict:
    """``runs`` against ``want`` (token arrays in one order): identical,
    or diverging only at counted near-ties of ``want``'s model."""
    near, diffs = _near_ties(name, runs, want, prompts, params, cfg)
    return dict(identical=len(runs) - near, near_ties=near,
                divergences=diffs)


def _sp_trace(vocab: int) -> list:
    """shared_prefix's requests: Poisson arrivals at SP_RATE a step, each
    prompt one of SP_HEADERS system headers of SP_HEADER_PAGES full pages
    plus a unique tail, as the reference bench's _shared_prefix_trace;
    then one request whose prompt is exactly header 0, arriving with the
    middle request (after header 0 is indexed), which must fork."""
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(SP_SEED)
    headers = [rng.integers(1, vocab, SP_HEADER_PAGES * PAGE)
               .astype(np.int32) for _ in range(SP_HEADERS)]
    t, out = 0.0, []
    for i in range(SP_REQUESTS):
        t += float(rng.exponential(1.0 / SP_RATE))
        tail = rng.integers(1, vocab, int(rng.integers(
            SP_TAIL[0], SP_TAIL[1] + 1))).astype(np.int32)
        out.append(Request(
            prompt=np.concatenate([headers[i % SP_HEADERS], tail]),
            max_new=int(rng.integers(SP_MAX_NEW[0], SP_MAX_NEW[1] + 1)),
            arrival_t=t))
    out.append(Request(prompt=headers[0].copy(), max_new=SP_MAX_NEW[0],
                       arrival_t=out[SP_REQUESTS // 2].arrival_t))
    return out


def _timed_steps(device: str):
    return (_StepTimes(chunks=True) if device == "cuda"
            else contextlib.nullcontext())


def _rehearsal_cut(cfg):
    """cfg, or in a CPU rehearsal (REHEARSAL) its cut for the host."""
    if not REHEARSAL:
        return cfg
    if cfg.family == "moe":
        from repro_torch.config import get_reduced_config
        return get_reduced_config(cfg.name)
    return cfg.with_(n_layers=1)


def _held_rerun(fn, what: str, device: str) -> tuple:
    """fn() once more, after its phase's counts are read, with every
    decode launch held to its plain version on its own inputs
    (``_held_to_plain``): on the card, every paged-decode launch of the
    path within PAGED_TOL.  Returns (fn's result, the launches held and
    their largest share of the tolerance)."""
    held = {}
    with _held_to_plain(held):
        out = fn()
        sync()
    shares = _shares(held)
    if device == "cuda":
        check("paged_decode_attention" in shares, f"{what}: no paged-decode "
              "launch was held to its plain version")
        _check_held({"held_to_plain": shares}, what)
    return out, shares


def _sp_serve(cfg, params, trace, prefix_cache: bool) -> tuple:
    """A paged engine for shared_prefix, clones of the trace, and a call
    that serves them."""
    from repro_torch.serving.engine import ContinuousEngine
    eng = ContinuousEngine(cfg, params, n_slots=SP_SLOTS, max_seq=SP_MAX_SEQ,
                           prefix_cache=prefix_cache)
    reqs = [r.clone() for r in trace]
    return eng, reqs, lambda: eng.run(reqs)


def _sp_run(cfg, params, trace, prefix_cache: bool, device: str) -> dict:
    """One shared_prefix replay; the tokens in trace order and its
    numbers."""
    from repro_torch.kernels import ops
    eng, reqs, serve = _sp_serve(cfg, params, trace, prefix_cache)
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    with _timed_steps(device) as steps:
        res = serve()
        sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["paged_decode_attention"]
    toks = [res[r.rid].tokens for r in reqs]
    stats = eng.kv_cache_stats()
    a = eng.slots.allocator
    refs_before_clear = a.n_live_refs()
    if eng.slots.prefix_index is not None:
        eng.slots.prefix_index.clear()
    drained = a.in_use == 0 and a.reserved == 0 and a.n_live_refs() == 0
    n_tok = sum(len(t) for t in toks)
    if device == "cuda":
        check(launches == cfg.n_layers * eng.decode_steps_total,
              f"shared_prefix ({prefix_cache}): paged launches {launches} "
              f"!= {cfg.n_layers} x {eng.decode_steps_total} decode steps")
    check(drained, f"shared_prefix ({prefix_cache}): pool not drained")
    keys = ("peak_pages_in_use", "peak_pages_committed", "cow_page_copies",
            "prefill_positions_skipped", "prefix_hits", "prefix_misses",
            "prefix_pages_attached", "prefix_pages_evicted",
            "prefix_index_pages")
    out = dict(prefix_cache=prefix_cache, wall_s=wall,
               tokens_per_s=n_tok / wall, generated_tokens=n_tok,
               ticks=eng.clock, decode_steps=eng.decode_steps_total,
               prefill_tokens=eng.prefill_tokens_total,
               prefill_s=(sum(steps.seconds("chunk")) if device == "cuda"
                          else None),
               decode_s=(sum(steps.seconds("decode")) if device == "cuda"
                         else None),
               launches=launches, refs_before_clear=refs_before_clear,
               pool_drained=drained,
               **{k: stats[k] for k in keys if k in stats})
    return out, toks


def phase_shared_prefix(device: str = "cuda") -> int:
    """smollm-360m at full width and depth in fp32 (TF32 off) through the
    paged ContinuousEngine with prefix_cache=True, then False, on the same
    trace and pool: token-exact apart from counted near-ties, fewer
    prefill tokens and a lower page peak shared, hits and at least one
    copy-on-write, the pool drained after the index is cleared, and one
    paged-decode launch a layer and decode step in each run.  Then the
    shared run once more with every paged-decode launch (aliased block
    tables after each hit) held to its plain version.  Returns the shared
    run's paged launches."""
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _rehearsal_cut(get_config("smollm-360m").with_(
        n_layers=SP_LAYERS, param_dtype="float32",
        activation_dtype="float32"))
    params = T.init_params(cfg, seed=0, device=device)
    trace = _sp_trace(cfg.vocab_size)
    shared, toks_s = _sp_run(cfg, params, trace, True, device)
    unshared, toks_u = _sp_run(cfg, params, trace, False, device)
    _, reqs, serve = _sp_serve(cfg, params, trace, True)
    res, held = _held_rerun(serve, "shared_prefix", device)
    held["tokens_identical_to_shared_run"] = all(
        np.array_equal(res[r.rid].tokens, t) for r, t in zip(reqs, toks_s))
    ties = _exact_or_near_ties("shared", toks_s, toks_u,
                               [r.prompt for r in trace], params, cfg)
    check(shared["prefill_tokens"] < unshared["prefill_tokens"]
          and shared["peak_pages_in_use"] < unshared["peak_pages_in_use"],
          f"shared_prefix: prefill tokens {shared['prefill_tokens']} / "
          f"{unshared['prefill_tokens']}, peak pages "
          f"{shared['peak_pages_in_use']} / {unshared['peak_pages_in_use']}")
    check(shared["prefix_hits"] > 0 and shared["cow_page_copies"] >= 1,
          f"shared_prefix: {shared['prefix_hits']} hits, "
          f"{shared['cow_page_copies']} copy-on-write forks")
    emit("shared_prefix", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="float32", tf32=False, n_requests=len(trace),
         headers=SP_HEADERS, header_tokens=SP_HEADER_PAGES * PAGE,
         tail=list(SP_TAIL), max_new=list(SP_MAX_NEW), rate=SP_RATE,
         slots=SP_SLOTS, max_seq=SP_MAX_SEQ, shared=shared,
         unshared=unshared, tokens=ties, shared_held_to_plain=held)
    del params
    return shared["launches"]


def _spec_prompts(vocab: int) -> list:
    rng = np.random.default_rng(SPEC_SEED)
    return [rng.integers(1, vocab, int(rng.integers(SPEC_PROMPTS[0],
                                                    SPEC_PROMPTS[1] + 1)))
            .astype(np.int32) for _ in range(SPEC_N)]


def _self_draft_rounds(S: int) -> int:
    """Rounds of a self-drafting run (every draft accepted) of one prompt
    of S tokens, from the same decoder on the CPU with a one-layer model:
    under full acceptance the rounds follow from max_new and k alone."""
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.models import transformer as T
    from repro_torch.serving.speculative import speculative_generate
    tiny = TP.GROUND.with_(n_layers=1, d_model=96, n_heads=2, n_kv_heads=1,
                           d_ff=128, param_dtype="float32",
                           activation_dtype="float32")
    p = T.init_params(tiny, seed=0, device="cpu")
    prompt = np.arange(1, S + 1, dtype=np.int32) % tiny.vocab_size
    res = speculative_generate(p, tiny, p, tiny, prompt, max_new=SPEC_MAX_NEW,
                               k=SPEC_K)
    check(res.accepted == res.drafted, "cpu self-draft rejected a draft")
    return res.rounds


def _spec_engines(dcfg, dparams, tcfg, tparams, S: int) -> tuple:
    """The one-slot draft and target engines of one prompt of S tokens."""
    from repro_torch.serving.speculative import _one_shot_engine
    return (_one_shot_engine(dcfg, dparams, S, SPEC_MAX_NEW + SPEC_K + 2),
            _one_shot_engine(tcfg, tparams, S, SPEC_MAX_NEW, draft_k=SPEC_K))


def phase_speculative(device: str = "cuda") -> int:
    """The tiansuan GROUND tier uncut in fp32 (TF32 off) through the
    port's SpeculativeDecoder with k = draft_k = SPEC_K: drafting for
    itself (every draft accepted, the rounds a CPU rehearsal gives) and
    drafted for by ONBOARD (random seed-0/seed-1 weights, almost nothing
    accepted).  Each case's tokens equal greedy_generate of the target on
    the same device (apart from counted near-ties), the verify pass runs,
    and the paged-decode launches equal both engines' layers x decode
    steps.  Then each case's longest prompt once more with every
    paged-decode launch of both one-slot engines held to its plain
    version.  Returns the launches of the speculative runs."""
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.speculative import (SpeculativeDecoder,
                                                 greedy_generate)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    onboard, ground = (_rehearsal_cut(c.with_(param_dtype="float32",
                                              activation_dtype="float32"))
                       for c in (TP.ONBOARD, TP.GROUND))
    dparams = T.init_params(onboard, seed=0, device=device)
    tparams = T.init_params(ground, seed=1, device=device)
    prompts = _spec_prompts(ground.vocab_size)
    want = [greedy_generate(tparams, ground, p, max_new=SPEC_MAX_NEW)
            for p in prompts]
    total, cases = 0, {}
    for case, dcfg, dp in (("self_draft", ground, tparams),
                           ("cross_model", onboard, dparams)):
        runs, rows = [], []
        for prompt in prompts:
            S = len(prompt)
            drf, tgt = _spec_engines(dcfg, dp, ground, tparams, S)
            sync()
            ops.reset_launches()
            t0 = time.perf_counter()
            res = SpeculativeDecoder(drf, tgt, k=SPEC_K).generate(
                prompt, SPEC_MAX_NEW)
            sync()
            wall = time.perf_counter() - t0
            n = ops.launch_counts()["paged_decode_attention"]
            d_l = dcfg.n_layers * drf.decode_steps_total
            t_l = ground.n_layers * tgt.decode_steps_total
            if device == "cuda":
                check(n == d_l + t_l, f"speculative {case}: paged launches "
                      f"{n} != {d_l} (draft) + {t_l} (target)")
            total += n
            st = tgt.spec_stats()
            check(st["verify_passes"] > 0, f"speculative {case}: no verify "
                  f"pass ran {st}")
            if case == "self_draft":
                rounds = _self_draft_rounds(S)
                check(res.accepted == res.drafted and res.rounds == rounds,
                      f"speculative self-draft: accepted {res.accepted} of "
                      f"{res.drafted}, {res.rounds} rounds (cpu {rounds})")
            runs.append(res.tokens)
            rows.append(dict(prompt_len=S, wall_s=wall, rounds=res.rounds,
                             drafted=res.drafted, accepted=res.accepted,
                             ledger=res.ledger.summary(),
                             verify_passes=st["verify_passes"],
                             draft_decode_steps=drf.decode_steps_total,
                             target_decode_steps=tgt.decode_steps_total,
                             draft_launches=d_l, target_launches=t_l,
                             tokens_per_s=len(res.tokens) / wall))
        ties = _exact_or_near_ties(case, runs, want, prompts, tparams, ground)
        i = max(range(len(prompts)), key=lambda j: len(prompts[j]))

        def longest():
            drf, tgt = _spec_engines(dcfg, dp, ground, tparams,
                                     len(prompts[i]))
            return SpeculativeDecoder(drf, tgt, k=SPEC_K).generate(
                prompts[i], SPEC_MAX_NEW).tokens

        toks, held = _held_rerun(longest, f"speculative {case}", device)
        held.update(prompt_len=len(prompts[i]),
                    tokens_identical_to_timed_run=bool(
                        np.array_equal(toks, runs[i])))
        cases[case] = dict(draft=dcfg.name, target=ground.name, runs=rows,
                           tokens_vs_greedy=ties, longest_held_to_plain=held)
    emit("speculative", dtype="float32", tf32=False, k=SPEC_K,
         max_new=SPEC_MAX_NEW, n_prompts=len(prompts), cases=cases)
    return total


def _cn_trace(vocab: int) -> list:
    """constellation's requests: one a tick from t = 0, every third at
    priority 1."""
    from repro_torch.serving.batching import Request
    rng = np.random.default_rng(CN_SEED)
    out = []
    for i in range(CN_REQUESTS):
        S = int(rng.integers(CN_PROMPTS[0], CN_PROMPTS[1] + 1))
        out.append(Request(
            prompt=rng.integers(1, vocab, S).astype(np.int32),
            max_new=int(rng.integers(CN_MAX_NEW[0], CN_MAX_NEW[1] + 1)),
            arrival_t=float(i), priority=int(i % 3 == 2)))
    return out


def _cn_engine(cfg, params):
    from repro_torch.serving.engine import ContinuousEngine
    return ContinuousEngine(cfg, params, n_slots=CN_SLOTS, max_seq=CN_MAX_SEQ,
                            page_size=PAGE, prefill_budget_tokens=CN_BUDGET)


def _cn_solo(cfg, params, trace) -> list:
    """The solo comparator: the requests through one PreemptiveScheduler
    on one engine of the same shape; tokens in trace order."""
    from repro_torch.serving.scheduler import PreemptiveScheduler
    sched = PreemptiveScheduler(_cn_engine(cfg, params))
    reqs = [r.clone() for r in trace]
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()
    return [sched.results[r.rid].tokens for r in reqs]


def _cn_run(cfg, params, trace, *, policy, handover, faulted,
            device) -> tuple:
    """One CONSTELLATION replay through ConstellationScheduler.run, every
    request uplinked via satellite 0, with the single-ownership check
    after every tick (the instance's ``tick`` wrapped for the run).
    Returns (numbers, tokens in trace order)."""
    import gc
    from repro_torch.configs.tiansuan_constellation import CONSTELLATION as C
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.link import ContactSchedule
    from repro_torch.kernels import ops
    from repro_torch.serving.constellation import ConstellationScheduler
    engines = [_cn_engine(cfg, params) for _ in range(C["n_satellites"])]
    ws = ContactSchedule(contact_duration_s=C["contact_duration_s"],
                         seed=C["schedule_seed"]).step_window_sets(
        C["s_per_step"], C["horizon_s"], n_satellites=C["n_satellites"],
        n_stations=C["n_stations"], contacts_per_day=C["contacts_per_day"])
    inj = FaultInjector(FaultPlan(**CN_FAULTS)) if faulted else None
    cs = ConstellationScheduler(
        engines, window_sets=ws, n_stations=C["n_stations"],
        s_per_step=C["s_per_step"], horizon_s=C["horizon_s"], policy=policy,
        handover=handover, handover_margin_ticks=C["handover_margin_ticks"],
        isl_mbps=C["isl_mbps"],
        frame_bytes=CN_FAULT_FRAME if faulted else C["frame_bytes"],
        link_max_retries=(CN_FAULT_RETRIES if faulted
                          else C["link_max_retries"]), faults=inj)
    reqs = [r.clone() for r in trace]
    tick, ticks = cs.tick, []

    def tick_owned_once():
        tick()
        ticks.append(cs.clock)
        own = cs.ownership()
        check(all(len(v) == 1 for v in own.values()),
              f"constellation ({policy}): a rid owned twice at tick "
              f"{cs.clock}: {own}")

    cs.tick = tick_owned_once
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        rep = cs.run([reqs] + [[] for _ in cs.sats[1:]])
        sync()
    finally:
        del cs.tick
    wall = time.perf_counter() - t0
    n_ticks = len(ticks)
    launches = ops.launch_counts()["paged_decode_attention"]
    steps = sum(e.decode_steps_total for e in engines)
    if device == "cuda":
        check(launches == cfg.n_layers * steps,
              f"constellation ({policy}): paged launches {launches} != "
              f"{cfg.n_layers} x {steps} decode steps")
    check(not rep.undelivered and sorted(rep.tokens) == sorted(
        r.rid for r in reqs), f"constellation ({policy}): undelivered "
        f"{rep.undelivered}")
    drained = all(e.slots.allocator.in_use == 0
                  and e.slots.allocator.reserved == 0
                  and e.slots.allocator.n_live_refs() == 0 for e in engines)
    check(drained and all(len(s.store) == 0 for s in cs.sats)
          and all(len(l) == 0 for l in [*cs.lanes, *cs.isl]),
          f"constellation ({policy}): pools, spill stores or lanes not "
          "drained")
    n_tok = sum(len(t) for t in rep.tokens.values())
    out = dict(policy=policy, handover=handover, faulted=faulted,
               wall_s=wall, tokens_per_s=n_tok / wall, ticks_run=n_ticks,
               final_clock=rep.final_clock, goodput=rep.goodput,
               delivered_tokens=rep.delivered_tokens,
               n_handovers=rep.n_handovers,
               n_result_forwards=rep.n_result_forwards,
               n_handover_redos=rep.n_handover_redos,
               assigned_pass_ticks=rep.assigned_pass_ticks,
               decode_steps=steps, launches=launches,
               bytes_downlinked=[l.get("bytes_downlinked", 0.0)
                                 for l in rep.fleet],
               bytes_isl=[l.get("bytes_isl", 0.0) for l in rep.fleet],
               energy_j=[cs.fleet.energy_j(k) for k in range(cs.n_sats)],
               within_energy_budget=rep.within_energy_budget,
               redo_from_corruption=[s["n_redo_from_corruption"]
                                     for s in rep.sat_stats])
    if inj is not None:
        lanes = [*rep.lane_stats, *rep.isl_stats]
        out.update(
            injected=dict(n_frames_lost=inj.n_frames_lost,
                          n_frame_corruptions=inj.n_frame_corruptions,
                          n_spill_corruptions=inj.n_spill_corruptions,
                          total=inj.n_corruptions_injected),
            detected=sum(l["n_corruptions_detected"] for l in lanes)
            + sum(s["n_spill_corruptions_detected"] for s in rep.sat_stats),
            silent=sum(l["n_silent_corruptions"] for l in lanes))
    toks = [rep.tokens[r.rid] for r in reqs]
    tmp = cs._tmp.name
    del cs, engines, tick
    gc.collect()
    check(not os.path.exists(tmp), f"constellation: {tmp} outlived its "
          "scheduler")
    return out, toks


def phase_constellation(device: str = "cuda") -> int:
    """configs/tiansuan_constellation.py's CONSTELLATION uncut (3 ONBOARD
    satellites, 2 stations, its window sets, planner and ISL) in fp32
    (TF32 off): the pooled replay (value planning, handover), the
    independent-pairs replay (static, no handover) and a solo
    PreemptiveScheduler on one engine.  Both replays token-exact with the
    solo run apart from counted near-ties, the pooled one handing over
    and at least as much goodput, everything delivered and drained, one
    owner per rid at every tick; then the pooled replay under the
    reference bench's constellation fault plan: token-exact, every
    injected corruption detected, none silent; last the pooled replay
    once more with every paged-decode launch held to its plain version.
    Returns the pooled run's paged launches."""
    from repro_torch.configs import tiansuan_constellation as TC
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _rehearsal_cut(TC.SATELLITE.with_(param_dtype="float32",
                                            activation_dtype="float32"))
    params = T.init_params(cfg, seed=0, device=device)
    trace = _cn_trace(cfg.vocab_size)
    prompts = [r.prompt for r in trace]
    want = _cn_solo(cfg, params, trace)
    runs, ties = {}, {}
    for name, kw in (("pooled", dict(policy="value", handover=True,
                                     faulted=False)),
                     ("independent", dict(policy="static", handover=False,
                                          faulted=False)),
                     ("faulted", dict(policy="value", handover=True,
                                      faulted=True))):
        runs[name], toks = _cn_run(cfg, params, trace, device=device, **kw)
        ties[name] = _exact_or_near_ties(name, toks, want, prompts, params,
                                         cfg)
    pooled, indep, faulted = runs["pooled"], runs["independent"], \
        runs["faulted"]
    check(pooled["n_handovers"] > 0 and pooled["bytes_isl"][0] > 0,
          f"constellation: {pooled['n_handovers']} handovers, satellite 0 "
          f"sent {pooled['bytes_isl'][0]} ISL bytes")
    check(pooled["goodput"] >= indep["goodput"],
          f"constellation: pooled goodput {pooled['goodput']} < "
          f"independent {indep['goodput']}")
    check(faulted["injected"]["total"] > 0
          and faulted["detected"] == faulted["injected"]["total"]
          and faulted["silent"] == 0,
          f"constellation faulted: {faulted['detected']} detected of "
          f"{faulted['injected']}, {faulted['silent']} silent")
    check(faulted["n_handovers"] > 0, "constellation faulted: no handover")
    (_, toks), held = _held_rerun(
        lambda: _cn_run(cfg, params, trace, policy="value", handover=True,
                        faulted=False, device=device),
        "constellation", device)
    held["tokens_vs_solo"] = _exact_or_near_ties("pooled_held", toks, want,
                                                 prompts, params, cfg)
    emit("constellation", satellite=cfg.name, dtype="float32", tf32=False,
         deployment={k: v for k, v in TC.CONSTELLATION.items()},
         n_requests=len(trace), slots=CN_SLOTS, max_seq=CN_MAX_SEQ,
         prefill_budget=CN_BUDGET, fault_plan=CN_FAULTS,
         fault_frame_bytes=CN_FAULT_FRAME, fault_retries=CN_FAULT_RETRIES,
         pooled=pooled, independent=indep, faulted=faulted,
         goodput_ratio=pooled["goodput"] / indep["goodput"],
         tokens_vs_solo=ties, pooled_held_to_plain=held)
    return pooled["launches"]


# --------------------------------------------------------------------------
# MoE and MLA serving: qwen3-moe-30b-a3b and deepseek-v3 at their widths
# --------------------------------------------------------------------------

def _free(what: str) -> None:
    """Collect (timing wrappers may hold an old pool through a cycle),
    return the allocator's cache, and print what is still allocated."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        emit("free", after=what, allocated_bytes=torch.cuda.memory_allocated(),
             max_allocated_bytes=torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def _static_capacity():
    """The engines' capacity loop starts at every token: the static
    drop-free worst case (C = the whole group), as capacity=None."""
    from repro_torch.models import moe as M
    saved = M.initial_capacity
    M.initial_capacity = lambda cfg, n_tok, factor=2.0: n_tok
    try:
        yield
    finally:
        M.initial_capacity = saved


def _family_trace(cfg, n, prompts, max_new, rate, seed) -> list:
    from repro_torch.serving.batching import poisson_trace
    return poisson_trace(n, rate=rate, prompt_lens=prompts, max_new=max_new,
                         vocab_size=cfg.vocab_size, seed=seed)


def _fixed_serve(phase: str, cfg, params, device: str, prompts: np.ndarray,
                 max_new: int, max_seq: int, want, gate, extra: dict = None,
                 decode_launches: int = None) -> tuple:
    """One fixed-slot batch: ServingEngine.generate on ``prompts`` (with
    the side inputs ``extra``) and ``gate`` deciding the batch, the
    tokens and logits checked.  On the card every launch count must
    equal ``want(engine)`` (a dict; a kernel it leaves out: 0); the row
    gets the prefill and decode times, and the prefill is run again
    profiled and held (``_prefill_checks``, on its own static MoE
    capacity: the whole group a slot).  With ``decode_launches`` (the
    decode launches a step makes), decode step CAPTURE_STEP is kept and
    checked too (``_decode_checks``).  Returns (the row, the engine)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    B, S = prompts.shape
    eng = ServingEngine(cfg, params, max_seq=max_seq)
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    timer = (_StepTimes(capture_at=None if decode_launches is None
                        else CAPTURE_STEP, chunks=True)
             if device == "cuda" else contextlib.nullcontext())
    with timer as steps:
        res = eng.generate(prompts, max_new=max_new, extra_inputs=extra)
        esc = int(gate.decide(torch.from_numpy(res.logits_last)
                              .to(device))["escalate"].sum())
        sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(res.tokens.shape == (B, max_new)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all())
          and bool(np.isfinite(res.logits_last).all())
          and bool(np.isfinite(res.prompt_logits).all()),
          f"{phase} fixed: bad tokens or logits")
    row = dict(batch=B, prompt_len=S, max_new=max_new, max_seq=max_seq,
               generated_tokens=B * max_new, wall_s=wall,
               tokens_per_s=B * max_new / wall, escalated=esc,
               launches=counts,
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
               first_token_top2_gap=_top2_gaps(res.prompt_logits))
    if device == "cuda":
        full = {**{k: 0 for k in counts}, **want(eng)}
        check(counts == full, f"{phase} fixed: launches {counts} != {full}")
        row.update(prefill_s=sum(steps.seconds("prefill")),
                   decode_s=sum(steps.seconds("decode")),
                   decode_s_per_step=sum(steps.seconds("decode")) / max_new,
                   cache_bytes=steps.cache_bytes)
        if decode_launches is not None:
            row["decode_step"] = _decode_checks(steps, decode_launches,
                                                profile=True)
            _check_held(row["decode_step"], f"{phase} decode step")
        row["prefill"] = _prefill_checks(params, cfg, prompts, phase, extra)
        _check_held(row["prefill"], f"{phase} prefill")
    return row, eng


def _family_serve(phase: str, cfg, params, device: str,
                  traffic: dict = MOE_TRAFFIC) -> dict:
    """One model in bf16 through both engines (the moe family, the
    dense configs, xLSTM).

    The ContinuousEngine (``traffic["slots"]`` slots, its max_seq, the
    default prefill budget; paged for dense and moe, contiguous with
    exact-length admission for xLSTM) serves ``traffic["requests"]``
    Poisson arrivals and the gate decides every result; then
    ServingEngine.generate on ``traffic["fixed"]`` (batch, prompt, new
    tokens).  Launch counts exact: paged decode = layers x decode steps
    (MLA's absorbed decode and xLSTM's recurrent steps are plain: 0),
    flash = layers x fixed-slot prefill attempts (the capacity loop
    re-runs a prefill that overflowed; xLSTM: 0), contiguous decode =
    layers x fixed-slot steps (not MLA, not xLSTM), one gate per
    result.  Then, after the counts are read, the paged run's decode
    step CAPTURE_STEP and the fixed-slot prefill once more under
    torch.profiler (``_decode_checks``, ``_prefill_checks``: the
    device's busy share of their wall and the largest kernels), and a
    shorter rerun of both engines with every flash and decode launch
    held to its plain version on its own inputs.  Returns the phase's
    launch counts."""
    from repro_torch.core.gating import ConfidenceGate
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ContinuousEngine
    tr = traffic
    attn = cfg.family in ("dense", "moe")      # attention on the kernels
    mla = cfg.mla is not None
    L_ = cfg.n_layers
    dec_layers = L_ if attn and not mla else 0  # decode launches a step
    gate = ConfidenceGate()
    reqs = _family_trace(cfg, tr["requests"], tr["prompts"], tr["max_new"],
                         tr["rate"], tr["seed"])
    eng = ContinuousEngine(cfg, params, n_slots=tr["slots"],
                           max_seq=tr["max_seq"])
    sync()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    timer = (_StepTimes(capture_at=CAPTURE_STEP, chunks=True)
             if device == "cuda" else contextlib.nullcontext())
    with timer as steps:
        results = eng.run([r.clone() for r in reqs])
        escalated = sum(bool(gate.decide(torch.from_numpy(
            r.logits_last[None]).to(device))["escalate"][0])
            for r in results.values())
        sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    check(len(results) == len(reqs), f"{phase}: requests lost")
    for r, q in zip(sorted(results.values(), key=lambda r: r.rid),
                    sorted(reqs, key=lambda r: r.rid)):
        check(len(r.tokens) == q.max_new
              and bool(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all())
              and bool(np.isfinite(r.logits_last).all()),
              f"{phase}: bad tokens or logits for rid {r.rid}")
    n_tok = sum(len(r.tokens) for r in results.values())
    paged = dict(layout=eng.kv_layout, n_requests=len(reqs), ticks=eng.clock,
                 decode_steps=eng.decode_steps_total,
                 prefill_tokens=eng.prefill_tokens_total,
                 generated_tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall, escalated=escalated,
                 capacity_retries=len(eng.moe_overflows),
                 retry_overflows=list(eng.moe_overflows),
                 launches=counts, peak_mem_bytes=peak,
                 kv=eng.kv_cache_stats())
    if device == "cuda":
        paged.update(prefill_chunk_s=sum(steps.seconds("chunk")),
                     decode_s=sum(steps.seconds("decode")),
                     decode_s_per_step=(sum(steps.seconds("decode"))
                                        / max(eng.decode_steps_total, 1)))
        want = dict(paged_decode_attention=dec_layers
                    * eng.decode_steps_total,
                    confidence_gate=len(results), flash_attention=0,
                    decode_attention=0, ssm_chunk_scan=0)
        check(all(counts[k] == v for k, v in want.items()),
              f"{phase} {eng.kv_layout}: launches {counts} != {want}")
        paged["decode_step"] = _decode_checks(steps, dec_layers,
                                              profile=True)
        _check_held(paged["decode_step"], f"{phase} decode step")
    del eng, steps
    # fixed-slot
    B, S, max_new = tr["fixed"]
    prompts = np.random.default_rng(tr["seed"] + 1).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)

    def want(feng):
        # the capacity loop re-runs a prefill that overflowed
        attempts = 1 + len(feng.moe_overflows)
        return dict(flash_attention=L_ * attempts if attn else 0,
                    decode_attention=dec_layers * max_new,
                    confidence_gate=1)
    fixed, feng = _fixed_serve(phase, cfg, params, device, prompts, max_new,
                               tr["max_seq"], want, gate)
    fixed.update(prefill_attempts=1 + len(feng.moe_overflows),
                 retry_overflows=list(feng.moe_overflows))
    if device == "cuda":
        total = torch.cuda.get_device_properties(0).total_memory
        check(max(fixed["peak_mem_bytes"], paged["peak_mem_bytes"]) < total,
              f"{phase}: peak memory over the card's {total} bytes")
    # a shorter rerun with every flash and decode launch held to plain
    held = {}
    with _held_to_plain(held):
        ContinuousEngine(cfg, params, n_slots=tr["slots"],
                         max_seq=tr["max_seq"]).run(
            [r.clone() for r in reqs[:tr["held_requests"]]])
        feng.generate(prompts, max_new=tr["held_new"])
        sync()
    shares = _shares(held)
    if device == "cuda":
        need = ({"flash_attention"} if attn else set()) | (
            {"paged_decode_attention", "decode_attention"} if dec_layers
            else set())
        check(need <= set(shares), f"{phase}: held rerun launched only "
              f"{sorted(shares)} of {sorted(need)}")
        _check_held({"held_to_plain": shares}, phase)
    emit(phase, arch=cfg.name, n_layers=L_, param_dtype=cfg.param_dtype,
         param_bytes=_tree_bytes(params), paged=paged, fixed=fixed,
         held_to_plain=shares)
    return {k: counts[k] + fixed["launches"][k] for k in counts}


def _family_invariants(phase: str, cfg, params, device: str) -> dict:
    """The serving invariants of one moe-family or dense model in fp32
    (TF32 off) on ``device``: the paged engine (chunks of 64) against the
    paged engine with one chunk per prompt, the contiguous engine
    (monolithic prefill), for moe also both under the static drop-free
    capacity, and fixed-slot ServingEngine on a same-length batch; for
    moe the dynamic-capacity prefill's logits against the static
    drop-free forward's; one preempt/resume round trip through
    PreemptiveScheduler (spill).  Greedy tokens identical, apart from
    counted near-ties of the paged run's model."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousEngine, ServingEngine
    from repro_torch.serving.scheduler import PreemptiveScheduler
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reqs = _family_trace(cfg, INV_REQUESTS, INV_PROMPTS, INV_MAX_NEW, 1.0,
                         MOE_SEED + 2)
    prompts = [r.prompt for r in reqs]
    t0 = time.perf_counter()
    want = _serve_tokens(cfg, params, reqs)                  # paged, chunked
    runs = {"paged_one_chunk": _serve_tokens(cfg, params, reqs,
                                             prefill_budget_tokens=None),
            "contiguous": _serve_tokens(cfg, params, reqs,
                                        kv_layout="contiguous")}
    if cfg.moe is not None:
        with _static_capacity():
            runs["paged_static_capacity"] = _serve_tokens(cfg, params, reqs)
            runs["contiguous_static_capacity"] = _serve_tokens(
                cfg, params, reqs, kv_layout="contiguous")
    out = {}
    for name, run in runs.items():
        out[name] = _exact_or_near_ties(name, run, want, prompts, params,
                                        cfg)
    # fixed-slot against the paged engine on one same-length batch
    batch = np.random.default_rng(MOE_SEED + 3).integers(
        1, cfg.vocab_size, (4, INV_FIXED_LEN)).astype(np.int32)
    feng = ServingEngine(cfg, params, max_seq=256)
    fixed = list(feng.generate(batch, max_new=INV_MAX_NEW[0]).tokens)
    out["fixed_vs_paged"] = _exact_or_near_ties(
        "fixed", fixed, _serve_tokens(cfg, params, [
            _request(p, INV_MAX_NEW[0]) for p in batch]), list(batch),
        params, cfg)
    if cfg.moe is not None:
        # the dynamic capacity bound against the static drop-free forward
        toks = torch.from_numpy(batch).to(params["embed"].device)
        overflows = []
        from repro_torch.serving.engine import _dynamic_capacity_prefill
        dyn, _ = _dynamic_capacity_prefill(
            lambda cap: T.forward(params, cfg, {"tokens": toks},
                                  moe_drop_free=True, moe_capacity=cap,
                                  return_cache=True),
            cfg, toks.numel(), overflows)
        exact, _ = T.forward(params, cfg, {"tokens": toks},
                             moe_drop_free=True)
        same_argmax = bool(torch.equal(dyn.argmax(-1), exact.argmax(-1)))
        out["dynamic_vs_static_prefill"] = dict(
            max_abs_diff=float((dyn - exact).abs().max()),
            same_argmax_every_position=same_argmax,
            retry_overflows=overflows)
        check(same_argmax, f"{phase}: the dynamic-capacity prefill's "
              "argmax differs from the static drop-free forward's")
    # one preempt/resume round trip, alone on the engine (the solo run's
    # decode batches have the same rows)
    req = reqs[0]
    solo = _serve_tokens(cfg, params, [req])[0]
    eng = ContinuousEngine(cfg, params, n_slots=4, max_seq=256)
    sched = PreemptiveScheduler(eng)
    probe = req.clone()
    sched.submit(probe)
    while not (eng.slots.decoding_slots()
               and len(eng.slots.states[eng.slots.decoding_slots()[0]]
                       .emitted) >= 3):
        sched.step()
    sched.preempt(eng.slots.decoding_slots()[0], "spill")
    got = sched.run()[probe.rid].tokens
    out["preempt_resume"] = _exact_or_near_ties(
        "preempt_resume", [got], [solo], [req.prompt], params, cfg)
    check(sched.n_preemptions == 1 and sched.n_resumes == 1
          and _drained(eng), f"{phase}: preempt/resume bookkeeping")
    n_seq = sum(v["identical"] + v["near_ties"] for v in out.values()
                if "identical" in v)
    near = sum(v["near_ties"] for v in out.values() if "near_ties" in v)
    emit(phase, arch=cfg.name, n_layers=cfg.n_layers,
         n_experts=cfg.moe.n_experts if cfg.moe else None,
         param_dtype=cfg.param_dtype,
         param_bytes=_tree_bytes(params), tf32=False,
         n_sequences_compared=n_seq, identical=n_seq - near,
         near_ties=near, seconds=time.perf_counter() - t0, **out)
    return out


def _init_timed(what: str, cfg, device: str, max_seq: int = 4096) -> dict:
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=device, max_seq=max_seq)
    sync()
    emit(f"{what}_init", arch=cfg.name, n_layers=cfg.n_layers,
         param_dtype=cfg.param_dtype, seconds=time.perf_counter() - t0,
         param_bytes=_tree_bytes(params),
         allocated_bytes=(torch.cuda.memory_allocated()
                          if device == "cuda" else None))
    return params


def phase_moe_serve(device: str = "cuda") -> dict:
    """qwen3-moe-30b-a3b's widths at MOE_SERVE_LAYERS layers in bf16 (128
    experts top-8, seeded random weights) through both engines
    (``_family_serve``); then its widths at MOE_INV_LAYERS layers in fp32
    for ``_family_invariants``.  Returns the serve's launch counts."""
    from repro_torch.config import get_config
    cfg = _rehearsal_cut(get_config("qwen3-moe-30b-a3b"))
    cfg = cfg.with_(n_layers=min(cfg.n_layers, MOE_SERVE_LAYERS))
    params = _init_timed("moe_serve", cfg, device)
    counts = _family_serve("moe_serve", cfg, params, device)
    del params
    _free("moe_serve bf16")
    c32 = cfg.with_(n_layers=min(cfg.n_layers, MOE_INV_LAYERS),
                    param_dtype="float32", activation_dtype="float32")
    params = _init_timed("moe_invariants", c32, device)
    _family_invariants("moe_invariants", c32, params, device)
    del params
    _free("moe_invariants")
    return counts


def phase_mla_serve(device: str = "cuda") -> dict:
    """deepseek-v3 at its published widths with the depth cut to
    MLA_LAYERS layers (3 dense-MLP + 1 MoE of 256 experts top-8 and a
    shared expert, the MTP block; ~31.6 GB in bf16) through both engines
    (``_family_serve``: flash at q/k 192 and v 128 in the fixed-slot
    prefill, MLA's absorbed attention plain on the paged and contiguous
    latent caches); then the same widths in fp32 (~63 GB; an allocation
    that does not fit raises) for ``_family_invariants``.  Returns the
    serve's launch counts."""
    from repro_torch.config import get_config
    cfg = _rehearsal_cut(get_config("deepseek-v3-671b")
                         .with_(n_layers=MLA_LAYERS))
    params = _init_timed("mla_serve", cfg, device)
    counts = _family_serve("mla_serve", cfg, params, device)
    del params
    _free("mla_serve bf16")
    c32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    params = _init_timed("mla_invariants", c32, device)
    _family_invariants("mla_invariants", c32, params, device)
    del params
    _free("mla_invariants")
    return counts


def _step_events(device: str):
    """A callback for ``train`` that records a CUDA event after each
    logged step (on the cpu, the host clock), and the list it fills."""
    marks = []

    def mark(_row=None):
        if device == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
    return mark, marks


def _span_ms(a, b) -> float:
    return a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3


def _train_counts(counts: dict, want_flash: int, what: str,
                  device: str) -> None:
    """Flash launches on a training run on the card are exact (forward
    and remat's recompute: 2 a layer a step); no other kernel runs.  The
    cpu's plain versions count nothing."""
    if device != "cuda":
        return
    check(counts["flash_attention"] == want_flash
          and sum(counts.values()) == want_flash,
          f"{what}: launches {counts}, want {want_flash} flash and nothing "
          "else")


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in fp32 (0 where both are zero)."""
    a, b = a.float(), b.float()
    nd = float(torch.linalg.vector_norm(a - b))
    nb = float(torch.linalg.vector_norm(b))
    return nd / nb if nb else (0.0 if nd == 0 else float("inf"))


def _step_rows(what: str, runs: dict, p32: dict, bounds) -> tuple:
    """Each run of ``runs`` (name -> (new params, first AdamW moment,
    metrics) after one step from ``p32``) against the run named
    "plain_fp32": the loss's relative error, the worst leaf's relative
    L2 error of the first AdamW moment (after one step (1 - b1) x the
    clipped gradient), and the update new - old (each leaf in fp32, all
    leaves at once in bf16: a bf16 norm weight of 1.0 cannot take an
    update of 1e-3).  ``bounds(name, dtype, rows)`` gives the run's
    (loss rtol, moment rel. L2, update rel. L2), checked, or None for a
    run that is only reported.  Returns (rows, the plain run's
    metrics)."""
    from repro_torch.tree import tree_leaves, tree_leaves_with_path
    new_p, mu_p, m_p = runs.pop("plain_fp32")
    names = ["/".join(map(str, k)) for k, _ in tree_leaves_with_path(p32)]
    old = tree_leaves(p32)
    upd_p = [n - o for n, o in zip(tree_leaves(new_p), old)]
    rows = {}
    for name, (new, mu, m) in runs.items():
        dtype = tree_leaves(new)[0].dtype
        tol = bounds(name, dtype, rows)
        grad = [_rel_l2(a, b) for a, b in zip(tree_leaves(mu),
                                               tree_leaves(mu_p))]
        upd = [n.float() - o for n, o in zip(tree_leaves(new), old)]
        if dtype == torch.float32:
            upd_err = max(_rel_l2(a, b) for a, b in zip(upd, upd_p))
        else:
            upd_err = _rel_l2(torch.cat([u.reshape(-1) for u in upd]),
                              torch.cat([u.reshape(-1) for u in upd_p]))
        row = dict(loss=m["loss"], loss_rel_err=abs(m["loss"] - m_p["loss"])
                   / abs(m_p["loss"]),
                   grad_norm=m["grad_norm"],
                   grad_norm_rel_err=abs(m["grad_norm"] - m_p["grad_norm"])
                   / m_p["grad_norm"],
                   grad_leaf_rel_l2=max(grad),
                   grad_leaf_worst=names[grad.index(max(grad))],
                   update_rel_l2=upd_err)
        rows[name] = row
        if tol is None:
            continue
        loss_tol, grad_tol, upd_tol = tol
        row["tol"] = dict(loss_rtol=loss_tol, grad_rel_l2=grad_tol,
                          update_rel_l2=upd_tol)
        check(np.isfinite(m["loss"]) and row["loss_rel_err"] <= loss_tol
              and row["grad_leaf_rel_l2"] <= grad_tol
              and upd_err <= upd_tol,
              f"{what} {name}: {row} against the plain fp32 step "
              f"(loss {m_p['loss']})")
    return rows, m_p


def phase_train_step(device: str = "cuda") -> None:
    """One training step through ``make_train_step`` at smollm-360m's
    full widths (960 wide, 15/5 heads of 64, vocab 49152) cut to
    TRAIN_CHECK_LAYERS layers, on train_smollm's first batch, from the
    same params (drawn in bf16) three ways, TF32 off: the kernel's path in
    fp32 and in bf16 (flash with its lse, FlashAttention's backward,
    remat, as train_smollm trains) and the plain path in fp32
    (mode="chunked": chunked_attention under autograd, no remat, no
    kernel launch).  Holds each kernel run to the plain one at
    TRAIN_CHECK_TOL: the loss; each leaf of the first AdamW moment, which
    after one step is (1 - b1) x the clipped gradient; and the update
    new - old, each leaf in fp32, all leaves at once in bf16 (a bf16
    norm weight of 1.0 cannot take an update of 1e-3)."""
    from repro_torch.config import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.tree import tree_map
    cfg = get_config("smollm-360m").with_(
        n_layers=1 if REHEARSAL else TRAIN_CHECK_LAYERS)
    cfg32 = cfg.with_(param_dtype="float32")
    opt = optim.OptimConfig(lr=TRAIN_LR, warmup_steps=1,
                            total_steps=TRAIN_STEPS)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    batch = {"tokens": torch.as_tensor(stream.batch(0)["tokens"],
                                       device=device)}
    p16 = T.init_params(cfg, seed=0, device=device)
    p32 = tree_map(lambda t: t.float(), p16)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for name, c, p, kw in (
                ("plain_fp32", cfg32, p32, dict(mode="chunked", remat=False)),
                ("kernel_fp32", cfg32, p32, {}),
                ("kernel_bf16", cfg, p16, {})):
            ops.reset_launches()
            new, st, m = make_train_step(c, opt, **kw)(
                p, optim.adamw_init(p, opt), batch)
            sync()
            _train_counts(ops.launch_counts(),
                          0 if name == "plain_fp32" else cfg.n_layers * 2,
                          f"train_step {name}", device)
            runs[name] = (new, st["mu"], {k: float(v) for k, v in m.items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rows, m_p = _step_rows("train_step", runs, p32,
                           lambda name, dtype, rows: TRAIN_CHECK_TOL[dtype])
    emit("train_step", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
         tf32=False, plain_fp32=dict(loss=m_p["loss"],
                                     grad_norm=m_p["grad_norm"]), **rows)


def phase_train_smollm(device: str = "cuda") -> dict:
    """launch/train.py's loop on smollm-360m at full width in bf16:
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens of the
    TokenStream (seed 0), every step logged.  The last loss must be below
    the first, and the flash launches exactly n_layers x steps x 2 (remat
    recomputes each block's forward in the backward).  Reports each
    step's time between CUDA events, tokens/s (every step's tokens over
    the sum of the steps' times), the median step, peak memory, one more
    step cut into forward, backward and update by CUDA events (the
    backward's share), and whole steps under torch.profiler (the
    device's busy share, the largest kernels).  Returns the launch
    counts and, under "readings", what the dryrun phase holds its
    prediction to."""
    from repro_torch.config import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.training.loop import init_state, train
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    cfg = get_config("smollm-360m")
    if REHEARSAL:
        cfg = cfg.with_(n_layers=1)
    opt = optim.OptimConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                            total_steps=TRAIN_STEPS)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    t0 = time.perf_counter()
    state = init_state(cfg, opt, device=device)
    sync()
    init_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mark, marks = _step_events(device)
    ops.reset_launches()
    mark()
    t0 = time.perf_counter()
    state = train(cfg, state, iter(stream), opt, steps=TRAIN_STEPS,
                  log_every=1, callback=mark)
    sync()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    losses = [r["loss"] for r in state.history]
    step_ms = [_span_ms(a, b) for a, b in zip(marks, marks[1:])]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train_smollm: losses {losses}")
    check(losses[-1] < losses[0], f"train_smollm: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    _train_counts(counts, cfg.n_layers * TRAIN_STEPS * 2, "train_smollm",
                  device)
    # one more step, cut into forward, backward and update
    batch = {"tokens": torch.as_tensor(stream.batch(TRAIN_STEPS)["tokens"],
                                       device=device)}
    p = tree_map(lambda t: t.detach().requires_grad_(True), state.params)
    mark, cut = _step_events(device)
    mark()
    with torch.enable_grad():
        total, _ = T.loss_fn(p, cfg, batch)
        mark()
        grads = torch.autograd.grad(total, tree_leaves(p))
    mark()
    optim.adamw_update(state.params, tree_unflatten(p, list(grads)),
                       state.opt_state, opt)
    mark()
    sync()
    fwd, bwd, upd = (_span_ms(a, b) for a, b in zip(cut, cut[1:]))
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    profiled = None
    if device == "cuda":
        # whole steps under torch.profiler: the device's busy share of
        # the wall and the largest kernels (times only: its windows may
        # drop records, so launches are counted by the wrappers above)
        step_fn = make_train_step(cfg, opt)
        by_kernel, wall_us = profile_device(
            lambda: step_fn(state.params, state.opt_state, batch), reps=2)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        profiled = dict(wall_ms=wall_us / 1e3,
                        device_ms=sum(by_kernel.values()) / 1e3,
                        busy_share=sum(by_kernel.values()) / wall_us,
                        top_kernels_us=dict(top))
    emit("train_smollm", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         vocab=cfg.vocab_size, dtype=cfg.param_dtype, steps=TRAIN_STEPS,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
         warmup=TRAIN_WARMUP, init_s=init_s, wall_s=wall_s,
         losses=losses, step_ms=step_ms, median_step_ms=steady,
         tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ * 1e3
         / sum(step_ms),
         peak_allocated_bytes=peak, cut_step_ms=dict(
             forward=fwd, backward=bwd, update=upd),
         backward_share=bwd / (fwd + bwd + upd), profiled_step=profiled,
         launches=counts)
    readings = dict(cfg=cfg, median_step_ms=steady, peak_bytes=peak,
                    flash_per_step=counts["flash_attention"] / TRAIN_STEPS,
                    param_bytes=_tree_bytes(state.params),
                    moment_bytes=_tree_bytes(state.opt_state["mu"])
                    + _tree_bytes(state.opt_state["nu"]))
    return dict(counts, readings=readings)


def _lm_tier_fn(cfg, params, device):
    """A cascade tier: the model's last-position logits (B, V) for a
    (B, S) token batch, on the device, under no_grad."""
    from repro_torch.models import transformer as T

    def fn(toks):
        with torch.no_grad():
            logits, _ = T.forward(params, cfg, {"tokens": torch.as_tensor(
                toks, device=device)}, remat=False)
        return logits[:, -1]
    return fn


def phase_lm_cascade(device: str = "cuda") -> dict:
    """tests/test_lm_cascade.py on the card: the tiansuan pair at its
    full width in bf16 trained on the TokenStream (ONBOARD 30 steps,
    GROUND 90, seq 96, batch 8, lr 2e-3, warmup 5), the gate calibrated
    to a 0.6 budget on the held-out batch 10,000 (the gate kernel on the
    CUDA logits), then the collaborative and the onboard-only cascade
    through CollaborativeEngine.  Checks the reference test's four
    assertions and exact flash and gate launches; prints the figures
    beside the JAX package's on the CPU (LM_CASCADE_REFERENCE).  Returns
    the launch counts of the whole phase."""
    from repro_torch.configs import tiansuan_pair as TP
    from repro_torch.core.cascade import CascadeConfig, CollaborativeEngine
    from repro_torch.core.gating import ConfidenceGate, calibrate_threshold
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.training import optim
    from repro_torch.training.loop import init_state, train
    stream = TokenStream(TokenStreamConfig(
        vocab_size=TP.ONBOARD.vocab_size, seq_len=LM_SEQ,
        batch_size=LM_BATCH))
    total = {}
    tiers, runs = {}, {}
    for name, cfg in (("onboard", TP.ONBOARD), ("ground", TP.GROUND)):
        steps = LM_STEPS[name]
        opt = optim.OptimConfig(lr=LM_LR, warmup_steps=LM_WARMUP,
                                total_steps=steps)
        st = init_state(cfg, opt, device=device)
        mark, marks = _step_events(device)
        ops.reset_launches()
        mark()
        t0 = time.perf_counter()
        st = train(cfg, st, iter(stream), opt, steps=steps, log_every=steps)
        mark()
        sync()
        counts = ops.launch_counts()
        _train_counts(counts, cfg.n_layers * steps * 2, f"lm_cascade {name}",
                      device)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        tiers[name] = (cfg, st.params)
        runs[name] = dict(steps=steps, losses=[r["loss"] for r in st.history],
                          wall_s=time.perf_counter() - t0,
                          step_ms=_span_ms(*marks) / steps,
                          flash_launches=counts["flash_attention"])
    check(runs["ground"]["losses"][-1] < runs["onboard"]["losses"][-1],
          f"lm_cascade: GROUND's last loss {runs['ground']['losses'][-1]} "
          f"is not below ONBOARD's {runs['onboard']['losses'][-1]}")

    eval_batch = stream.batch(LM_EVAL_STEP)["tokens"]
    prefix, target = eval_batch[:, :-1], eval_batch[:, -1]
    onboard_fn = _lm_tier_fn(*tiers["onboard"], device)
    ground_fn = _lm_tier_fn(*tiers["ground"], device)
    ops.reset_launches()
    conf = ConfidenceGate("max_prob", 1.1).decide(
        onboard_fn(prefix))["confidence"].cpu().numpy()
    thr = calibrate_threshold(conf, np.ones_like(conf, bool), LM_BUDGET)
    eng = CollaborativeEngine(onboard_fn, ground_fn, CascadeConfig(
        gate=ConfidenceGate("max_prob", thr), item_dtype_bytes=4),
        device=device)
    collab = eng.run(prefix, item_shape=prefix.shape[1:])
    onboard_only = eng.run(prefix, item_shape=prefix.shape[1:],
                           ground_available=False)
    sync()
    counts = ops.launch_counts()
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    s = collab.ledger.summary()
    n_esc = int(collab.escalated.sum())
    acc_c = float(np.mean(collab.predictions == target))
    acc_o = float(np.mean(onboard_only.predictions == target))
    # the probe and both runs: ONBOARD's forward and one gate each;
    # GROUND's forward once, on the collaborative run's escalations
    n_on, n_gr = tiers["onboard"][0].n_layers, tiers["ground"][0].n_layers
    want_flash = 3 * n_on + (n_gr if n_esc else 0)
    if device == "cuda":
        check(counts["confidence_gate"] == 3
              and counts["flash_attention"] == want_flash
              and sum(counts.values()) == 3 + want_flash,
              f"lm_cascade: cascade launches {counts}, want 3 gate and "
              f"{want_flash} flash")
    check(acc_c >= acc_o, f"lm_cascade: collaborative accuracy {acc_c} < "
          f"onboard-only {acc_o}")
    check(s["bytes_downlinked"] < s["bytes_bentpipe_baseline"],
          f"lm_cascade: {s['bytes_downlinked']} bytes downlinked, not below "
          f"the bent pipe's {s['bytes_bentpipe_baseline']}")
    check(0.0 < s["escalation_rate"] <= 0.7 + 1.0 / len(conf),
          f"lm_cascade: escalation rate {s['escalation_rate']}")
    emit("lm_cascade", onboard=runs["onboard"], ground=runs["ground"],
         threshold=thr, acc_collaborative=acc_c, acc_onboard_only=acc_o,
         escalated=n_esc, items=len(conf),
         escalation_rate=s["escalation_rate"],
         bytes_downlinked=s["bytes_downlinked"],
         bytes_bentpipe_baseline=s["bytes_bentpipe_baseline"],
         cascade_launches=counts, launches=total,
         reference_cpu=LM_CASCADE_REFERENCE)
    return total


# dense_configs_serve: granite-20b and qwen1.5-4b uncut in bf16 (40.6 and
# 7.9 GB of seeded random weights), each through both engines: DENSE_
# TRAFFIC's Poisson arrivals (prompts 64-512) on the paged engine, then a
# fixed-slot batch of 4 x 512; granite-20b's widths at DENSE_INV_LAYERS
# layers in fp32 for the serving invariants
DENSE_ARCHS = ("granite-20b", "qwen1.5-4b")
DENSE_TRAFFIC = dict(requests=8, prompts=(64, 512), max_new=(16, 32),
                     rate=0.5, seed=31, slots=8, max_seq=576,
                     fixed=(4, 512, 16), held_requests=2, held_new=4)
DENSE_INV_LAYERS = 2
# xlstm_serve: xlstm-1.3b at its widths cut to XLSTM_SERVE_LAYERS layers
# in bf16 on the contiguous engine
# (exact-length admission; the mLSTM's chunk is min(256, S), so prompts
# up to 256), then 4 x 256 fixed-slot; its widths at two blocks (one
# mLSTM, one sLSTM) in fp32 for prefill + decode against the forward,
# XLSTM_INV_STEPS steps, logits within XLSTM_INV_TOL (atol, rtol)
XLSTM_TRAFFIC = dict(requests=8, prompts=(32, 256), max_new=(16, 32),
                     rate=0.5, seed=41, slots=8, max_seq=320,
                     fixed=(4, 256, 16), held_requests=2, held_new=4)
XLSTM_INV_LEN, XLSTM_INV_STEPS = 64, 8
XLSTM_SERVE_LAYERS = 24
XLSTM_INV_TOL = (1e-4, 1e-4)
# train_families: FAMILY_STEPS steps of FAMILY_BATCH x TRAIN_SEQ (lr
# TRAIN_LR, FAMILY_WARMUP warmup steps, remat) of xlstm-1.3b at its widths
# cut to XLSTM_TRAIN_LAYERS layers (two units of seven mLSTM blocks and an
# sLSTM block; uncut, 48 layers, until sharded_train needed the smoke's
# time: 64 s of it) and of
# zamba2-7b at its widths cut to ZAMBA_TRAIN_LAYERS layers (two units of
# six Mamba2 blocks and the shared block), bf16; then one zamba2 step at
# ZAMBA_CHECK_LAYERS layers (one unit), TF32 off, the kernels' path in
# fp32 and bf16 against the plain path in fp32 (loss rtol, worst leaf of
# the first AdamW moment, the update; rel. L2): fp32 within train_step's
# fp32 tolerances; bf16 within BF16_GRAD_FACTOR times the error of the
# plain path run in bf16 on the same params (the type's own error: on
# reduced zamba2 on the CPU the plain bf16 step already errs 0.09 on
# A_log's moment and 0.29 on the update, past train_step's bf16 bounds),
# plus the fp32 tolerances
FAMILY_STEPS, FAMILY_BATCH, FAMILY_WARMUP = 10, 8, 3
ZAMBA_TRAIN_LAYERS, ZAMBA_CHECK_LAYERS = 12, 6
XLSTM_TRAIN_LAYERS = 16


def _family_cut(cfg):
    """cfg, or in a CPU rehearsal its reduced config (the widths of the
    new families' models do not fit a host)."""
    if not REHEARSAL:
        return cfg
    from repro_torch.config import get_reduced_config
    return get_reduced_config(cfg.name)


def phase_dense_configs_serve(device: str = "cuda") -> dict:
    """granite-20b (52 x 6144, 48 query heads over one KV head of 128:
    flash at GQA group 48, the decode kernels at granite's group) and
    qwen1.5-4b (40 x 2560, 20/20 heads of 128, qkv bias, vocab 151936)
    uncut in bf16, each through both engines (``_family_serve``); then
    granite-20b's widths at DENSE_INV_LAYERS layers in fp32 for
    ``_family_invariants`` (paged = one-chunk paged = contiguous =
    fixed-slot, a preempt/resume round trip).  granite-34b differs from
    granite-20b only in depth (88 layers) and is checked reduced on the
    CPU.  Returns the two serves' summed launch counts."""
    from repro_torch.config import get_config
    total = {}
    for arch in DENSE_ARCHS:
        tag = arch.replace("-", "_").replace(".", "_")
        cfg = _family_cut(get_config(arch))
        params = _init_timed(f"{tag}_serve", cfg, device)
        counts = _family_serve(f"{tag}_serve", cfg, params, device,
                               DENSE_TRAFFIC)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        del params
        _free(f"{tag}_serve")
    c32 = _family_cut(get_config(DENSE_ARCHS[0])).with_(
        n_layers=DENSE_INV_LAYERS, param_dtype="float32",
        activation_dtype="float32")
    params = _init_timed("granite_invariants", c32, device)
    _family_invariants("granite_invariants", c32, params, device)
    del params
    _free("granite_invariants")
    return total


def phase_xlstm_serve(device: str = "cuda") -> dict:
    """xlstm-1.3b's widths at XLSTM_SERVE_LAYERS blocks of 2048 in bf16
    (mLSTM with 4 heads of 1024, one sLSTM in 8; vocab 50304) through both engines
    (``_family_serve``: the contiguous engine, exact-length admission;
    no attention kernel runs, the gate decides every result; the decode
    step's busy share under torch.profiler).  Then its widths at two
    blocks in fp32, TF32 off: prefill XLSTM_INV_LEN tokens and decode
    XLSTM_INV_STEPS more against one forward over all of them, the
    logits within XLSTM_INV_TOL, the same argmax.  Returns the serve's
    launch counts."""
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    cfg = _family_cut(get_config("xlstm-1.3b"))
    cfg = cfg.with_(n_layers=min(cfg.n_layers, XLSTM_SERVE_LAYERS))
    params = _init_timed("xlstm_serve", cfg, device)
    counts = _family_serve("xlstm_serve", cfg, params, device, XLSTM_TRAFFIC)
    del params
    _free("xlstm_serve")
    c32 = cfg.with_(n_layers=2, param_dtype="float32",
                    activation_dtype="float32",
                    xlstm=dataclasses.replace(cfg.xlstm, slstm_every=2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params = T.init_params(c32, seed=0, device=device)
        n, k = XLSTM_INV_LEN, XLSTM_INV_STEPS
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            1, c32.vocab_size, (2, n + k)).astype(np.int32)).to(device)
        with torch.no_grad():
            full, _ = T.forward(params, c32, {"tokens": toks})
        logits, pcache = T.prefill(params, c32, {"tokens": toks[:, :n]})
        cache = T.graft_slot_cache(T.init_cache(c32, 2, n + k,
                                                device=device), pcache, 0)
        steps = [logits[:, 0]]
        for t in range(n, n + k - 1):
            out, cache = T.decode_step(params, c32, cache, toks[:, t:t + 1],
                                       t)
            steps.append(out[:, 0])
        got = torch.stack(steps, dim=1)
        want = full[:, n - 1:n + k - 1]
        err, excess = _max_excess(got, want, *XLSTM_INV_TOL)
        same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(excess <= 0 and same, f"xlstm_invariants: prefill + decode "
          f"against the forward: max_abs_err {err} (atol, rtol "
          f"{XLSTM_INV_TOL}), same argmax {same}")
    emit("xlstm_invariants", arch=c32.name, n_layers=2, tf32=False,
         prefill=n, decode_steps=k - 1, max_abs_err=err,
         share_of_tolerance=_share_of_tolerance(got, want, *XLSTM_INV_TOL),
         logit_max_abs=float(want.abs().max()), same_argmax=same)
    del params, cache, pcache
    _free("xlstm_invariants")
    return counts


def _train_family(phase: str, cfg, want: dict, device: str,
                  seq: int = TRAIN_SEQ) -> dict:
    """FAMILY_STEPS steps of ``training.loop.train`` on ``cfg`` in bf16
    (FAMILY_BATCH x ``seq`` of the TokenStream with launch/train.py's
    side inputs for audio and vlm, remat on): the loss
    must fall (the mean of the last three steps' below the first step's:
    zamba2's warmup to lr 1e-3 raises it for a few steps before it
    falls, and xLSTM's falls ~0.05 in ten steps with steps that go up by
    0.02; an exploratory run on an H100 80GB HBM3 at 700.00 W) and every
    launch count equal ``want`` (remat recomputes each block's forward
    in the backward: two forwards a step).
    Reports each step's CUDA-event time, tokens/s over every step, the
    median step and the peak memory.  Returns the launch counts."""
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.train import with_side_inputs
    from repro_torch.training import optim
    from repro_torch.training.loop import init_state, train
    opt = optim.OptimConfig(lr=TRAIN_LR, warmup_steps=FAMILY_WARMUP,
                            total_steps=FAMILY_STEPS)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        batch_size=FAMILY_BATCH))
    t0 = time.perf_counter()
    state = init_state(cfg, opt, max_seq=seq, device=device)
    sync()
    init_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mark, marks = _step_events(device)
    ops.reset_launches()
    mark()
    t0 = time.perf_counter()
    state = train(cfg, state,
                  with_side_inputs(cfg, iter(stream), FAMILY_BATCH), opt,
                  steps=FAMILY_STEPS, log_every=1, callback=mark)
    sync()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [r["loss"] for r in state.history]
    step_ms = [_span_ms(a, b) for a, b in zip(marks, marks[1:])]
    check(len(losses) == FAMILY_STEPS and all(np.isfinite(losses))
          and np.mean(losses[-3:]) < losses[0],
          f"{phase}: the loss did not fall: {losses}")
    if device == "cuda":
        check(counts == {**{k: 0 for k in counts}, **want},
              f"{phase}: launches {counts}, want {want} and nothing else")
    emit(phase, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         dtype=cfg.param_dtype, steps=FAMILY_STEPS, batch=FAMILY_BATCH,
         seq=seq, lr=TRAIN_LR, warmup=FAMILY_WARMUP,
         param_bytes=_tree_bytes(state.params), init_s=init_s,
         wall_s=wall_s, losses=losses, step_ms=step_ms,
         median_step_ms=sorted(step_ms)[len(step_ms) // 2],
         tokens_per_s=FAMILY_STEPS * FAMILY_BATCH * seq * 1e3
         / sum(step_ms),
         peak_allocated_bytes=(torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
         launches=counts)
    return counts


@contextlib.contextmanager
def _plain_ssd():
    """Inside the block every Mamba2 block's SSD scan runs the plain
    version (``ref.ssm_chunk_scan_ref``, differentiable PyTorch) on the
    card: the plain path of the zamba2 step check."""
    from repro_torch.kernels import ref
    from repro_torch.models import ssm as SSM
    saved = SSM.ssd_chunked
    SSM.ssd_chunked = lambda xh, dt, A, Bm, Cm, chunk, h0=None: \
        ref.ssm_chunk_scan_ref(xh, dt, A, Bm, Cm, chunk)
    try:
        yield
    finally:
        SSM.ssd_chunked = saved


def _zamba_step_check(device: str) -> None:
    """One ``make_train_step`` step of zamba2-7b at its widths cut to
    ZAMBA_CHECK_LAYERS layers (one unit: six Mamba2 blocks, the shared
    attention block), FAMILY_BATCH x TRAIN_SEQ, TF32 off, from the same
    params (drawn in bf16) four ways: the kernels' path in fp32 and in
    bf16 (flash and the SSD scan under autograd, remat) and the plain
    path (mode="chunked" attention, the plain SSD scan, no remat, no
    kernel launch) in fp32 and in bf16.  Each kernel run against the
    plain fp32 run, as train_step holds smollm's: the loss, each leaf of
    the first AdamW moment, the update; fp32 within TRAIN_CHECK_TOL's
    fp32 bounds, bf16 within BF16_GRAD_FACTOR times the plain bf16 run's
    own error plus those bounds."""
    from repro_torch.config import get_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.tree import tree_map
    cfg = _family_cut(get_config("zamba2-7b")).with_(
        n_layers=ZAMBA_CHECK_LAYERS)
    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    units = cfg.n_layers // cfg.shared_attn_every
    opt = optim.OptimConfig(lr=TRAIN_LR, warmup_steps=1,
                            total_steps=FAMILY_STEPS)
    batch = {"tokens": torch.as_tensor(TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=FAMILY_BATCH)).batch(0)["tokens"], device=device)}
    p16 = T.init_params(cfg, seed=0, device=device)
    p32 = tree_map(lambda t: t.float(), p16)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    kernel_launches = dict(flash_attention=2 * units,
                           ssm_chunk_scan=2 * cfg.n_layers)
    try:
        plain = dict(mode="chunked", remat=False)
        for name, c, p, kw in (
                ("plain_fp32", cfg32, p32, plain),
                ("plain_bf16", cfg, p16, plain),
                ("kernel_fp32", cfg32, p32, {}),
                ("kernel_bf16", cfg, p16, {})):
            ops.reset_launches()
            with (_plain_ssd() if name.startswith("plain")
                  else contextlib.nullcontext()):
                new, st, m = make_train_step(c, opt, **kw)(
                    p, optim.adamw_init(p, opt), batch)
            sync()
            counts = ops.launch_counts()
            if device == "cuda":
                want = {k: 0 for k in counts}
                if name.startswith("kernel"):
                    want.update(kernel_launches)
                check(counts == want, f"zamba_train_step {name}: launches "
                      f"{counts} != {want}")
            runs[name] = (new, st["mu"], {k: float(v) for k, v in m.items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    def bounds(name, dtype, rows):
        if name == "plain_bf16":          # the yardstick, not checked
            return None
        tol = TRAIN_CHECK_TOL[torch.float32]
        if name == "kernel_bf16":
            own = rows["plain_bf16"]
            tol = tuple(t + BF16_GRAD_FACTOR * own[k] for t, k in zip(
                tol, ("loss_rel_err", "grad_leaf_rel_l2", "update_rel_l2")))
        return tol
    rows, m_p = _step_rows("zamba_train_step", runs, p32, bounds)
    emit("zamba_train_step", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, batch=FAMILY_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
         tf32=False, plain_fp32=dict(loss=m_p["loss"],
                                     grad_norm=m_p["grad_norm"]), **rows)


def phase_train_families(device: str = "cuda") -> dict:
    """Training of the recurrent families on the card: xlstm-1.3b at its
    widths with XLSTM_TRAIN_LAYERS layers (no kernel: its blocks are
    plain) and zamba2-7b at its widths with
    ZAMBA_TRAIN_LAYERS layers (flash 2 a unit a step, the SSD scan 2 a
    Mamba2 block a step: the forward and remat's recompute; the SSD
    backward is the plain scan's), both in bf16 with a falling loss
    (``_train_family``); then ``_zamba_step_check``.  Returns the summed
    launch counts of the two runs."""
    from repro_torch.config import get_config
    xl = _family_cut(get_config("xlstm-1.3b"))
    xl = xl.with_(n_layers=min(xl.n_layers, XLSTM_TRAIN_LAYERS))
    total = _train_family("train_xlstm", xl, {}, device)
    _free("train_xlstm")
    zc = _family_cut(get_config("zamba2-7b"))
    zc = zc.with_(n_layers=min(zc.n_layers, ZAMBA_TRAIN_LAYERS))
    units = zc.n_layers // zc.shared_attn_every
    counts = _train_family("train_zamba2", zc, dict(
        flash_attention=2 * units * FAMILY_STEPS,
        ssm_chunk_scan=2 * zc.n_layers * FAMILY_STEPS), device)
    total = {k: total[k] + counts[k] for k in counts}
    _free("train_zamba2")
    _zamba_step_check(device)
    _free("zamba_train_step")
    return total


# whisper_serve and qwen2_vl_serve: one fixed-slot batch each through
# ServingEngine.generate with the family's side input (0.02 * randn from
# a seeded torch.Generator, as tests/helpers.py makes them), uncut in
# bf16: (batch, prompt tokens, new tokens, max_seq).  whisper-tiny: 8
# prompts of 64 tokens against 1500 frames, 64 new, max_seq 448 (its
# decoder's length; dec_pos is made that long); qwen2-vl-2b: 4 requests
# of 256 patches + 256 text tokens, 32 new, max_seq 1024
SIDE_TRAFFIC = {"audio": (8, 64, 64, 448), "vlm": (4, 256, 32, 1024)}
SIDE_SEED = 51
# audio_vlm_invariants: both uncut in fp32 (TF32 off): prefill
# SIDE_INV_LEN text tokens (qwen2-vl after its 256 patches) and decode
# one more against one forward over all of them, SIDE_INV_B sequences;
# logits within SIDE_INV_TOL (atol, rtol), the same argmax
SIDE_INV_B, SIDE_INV_LEN = 2, 64
SIDE_INV_TOL = (1e-4, 1e-4)
# train_audio_vlm: FAMILY_STEPS steps of FAMILY_BATCH x SIDE_TRAIN_SEQ
# text tokens of both uncut in bf16, with launch/train.py's side inputs
SIDE_TRAIN_SEQ = 128
SIDE_ARCHS = ("whisper-tiny", "qwen2-vl-2b")


def _side_inputs(cfg, B: int, device: str, seed: int) -> dict:
    """The family's side input, 0.02 * randn (B, n, d) fp32 from a seeded
    generator on ``device``: whisper's n_audio_frames frames, qwen2-vl's
    n_patches patch embeddings."""
    from repro_torch.config import side_input
    key, n = side_input(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {key: 0.02 * torch.randn((B, n, cfg.d_model), generator=gen,
                                    device=device)}


def _side_launches(cfg) -> tuple:
    """(flash launches a prefill, contiguous-decode launches a decode
    step): whisper one flash an encoder layer and two a decoder layer
    (self and cross), two decode launches a decoder layer (self, and the
    cross cache's); qwen2-vl one of each a layer."""
    if cfg.family == "audio":
        return cfg.n_encoder_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def _side_serve(phase: str, cfg, params, device: str) -> dict:
    """One fixed-slot batch of SIDE_TRAFFIC through
    ServingEngine.generate with the family's side input, the gate
    deciding the batch.  Launch counts exact (``_side_launches``: flash
    a prefill, contiguous decode a step times the new tokens, one gate
    launch, nothing else).  Then, after the counts are read, decode step
    CAPTURE_STEP once more counted (one decode launch a self or cross
    attention), its first decode launch alone in a CUDA graph (one
    kernel node), under torch.profiler (the busy share) and held to the
    plain version; and the prefill profiled and held, every flash launch
    (the cross-attention's at Sq != Skv among them) against the plain
    version on its own inputs.  Returns the launch counts."""
    from repro_torch.core.gating import ConfidenceGate
    B, S, max_new, max_seq = SIDE_TRAFFIC[cfg.family]
    prompts = np.random.default_rng(SIDE_SEED).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = _side_inputs(cfg, B, device, SIDE_SEED)
    flash, dec = _side_launches(cfg)
    fixed, _ = _fixed_serve(
        phase, cfg, params, device, prompts, max_new, max_seq,
        lambda eng: dict(flash_attention=flash,
                         decode_attention=dec * max_new, confidence_gate=1),
        ConfidenceGate(), extra=extra, decode_launches=dec)
    if device == "cuda":
        check("flash_attention" in fixed["prefill"]["held_to_plain"],
              f"{phase}: no flash launch of the prefill was held")
    row = dict(arch=cfg.name, n_layers=cfg.n_layers,
               n_encoder_layers=cfg.n_encoder_layers,
               param_dtype=cfg.param_dtype,
               param_bytes=_tree_bytes(params),
               side_input={k: list(v.shape) for k, v in extra.items()},
               **fixed)
    emit(phase, **row)
    return fixed["launches"]


def phase_side_serve(device: str = "cuda") -> dict:
    """whisper-tiny (4 + 4 layers of 384, 6/6 heads of 64, vocab 51865,
    1500 frames) and qwen2-vl-2b (28 x 1536, 12/2 heads of 128, M-RoPE,
    tied vocab 151936, 256 patches) uncut in bf16, each through
    ``_side_serve``.  Returns {phase: launch counts}."""
    from repro_torch.config import get_config
    out = {}
    for arch in SIDE_ARCHS:
        cfg = _family_cut(get_config(arch))
        tag = "whisper" if cfg.family == "audio" else "qwen2_vl"
        params = _init_timed(f"{tag}_serve", cfg, device,
                             max_seq=SIDE_TRAFFIC[cfg.family][3])
        out[f"{tag}_serve"] = _side_serve(f"{tag}_serve", cfg, params, device)
        del params
        _free(f"{tag}_serve")
    return out


def phase_audio_vlm_invariants(device: str = "cuda") -> None:
    """Both families uncut in fp32, TF32 off: prefill SIDE_INV_LEN text
    tokens (qwen2-vl after its patches), decode one more at position
    SIDE_INV_LEN (+ n_patches), against one forward over all of them
    (tests/test_models.py's invariant): the prefill's last logits and
    the step's within SIDE_INV_TOL, the same argmax."""
    from repro_torch.config import get_config
    from repro_torch.models import transformer as T
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    B, n = SIDE_INV_B, SIDE_INV_LEN
    try:
        for arch in SIDE_ARCHS:
            cfg = _family_cut(get_config(arch)).with_(
                param_dtype="float32", activation_dtype="float32")
            t0 = time.perf_counter()
            params = T.init_params(cfg, seed=0, device=device,
                                   max_seq=n + 1)
            toks = torch.from_numpy(np.random.default_rng(SIDE_SEED + 1)
                                    .integers(1, cfg.vocab_size, (B, n + 1))
                                    .astype(np.int32)).to(device)
            extra = _side_inputs(cfg, B, device, SIDE_SEED + 1)
            P = cfg.n_patches if cfg.family == "vlm" else 0
            with torch.no_grad():
                full, _ = T.forward(params, cfg, {"tokens": toks, **extra})
            logits, pcache = T.prefill(params, cfg,
                                       {"tokens": toks[:, :n], **extra})
            cache = T.graft_slot_cache(
                T.init_cache(cfg, B, n + 1 + P, device=device), pcache, 0)
            step, _ = T.decode_step(params, cfg, cache, toks[:, n:], n + P)
            got = torch.stack([logits[:, 0], step[:, 0]], dim=1)
            want = full[:, -2:]
            err, excess = _max_excess(got, want, *SIDE_INV_TOL)
            same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
            check(excess <= 0 and same, f"audio_vlm_invariants {arch}: "
                  f"prefill + decode against the forward: max_abs_err {err} "
                  f"(atol, rtol {SIDE_INV_TOL}), same argmax {same}")
            emit("audio_vlm_invariants", arch=cfg.name, tf32=False,
                 n_layers=cfg.n_layers, batch=B, prefill=n, patches=P,
                 max_abs_err=err,
                 share_of_tolerance=_share_of_tolerance(got, want,
                                                        *SIDE_INV_TOL),
                 logit_max_abs=float(want.abs().max()), same_argmax=same,
                 seconds=time.perf_counter() - t0)
            del params, cache, pcache
            _free(f"audio_vlm_invariants {arch}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def phase_train_audio_vlm(device: str = "cuda") -> dict:
    """FAMILY_STEPS steps of whisper-tiny and of qwen2-vl-2b uncut in
    bf16 through ``training.loop.train`` with launch/train.py's side
    inputs (``_train_family``, FAMILY_BATCH x SIDE_TRAIN_SEQ text
    tokens): the loss falls and flash launches exactly 2 a layer a step
    (the forward and remat's recompute; whisper's encoder, decoder and
    cross layers), nothing else.  Returns the summed launch counts."""
    from repro_torch.config import get_config
    total = {}
    for arch in SIDE_ARCHS:
        cfg = _family_cut(get_config(arch))
        flash = 2 * _side_launches(cfg)[0] * FAMILY_STEPS
        tag = "whisper" if cfg.family == "audio" else "qwen2_vl"
        counts = _train_family(f"train_{tag}", cfg,
                               dict(flash_attention=flash), device,
                               seq=SIDE_TRAIN_SEQ)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        _free(f"train_{tag}")
    return total


# --------------------------------------------------------------------------
# sharded_serve: ContinuousEngine(mesh=...) on SHARD_RANKS processes
# --------------------------------------------------------------------------
# The card is one GPU and NCCL refuses two ranks on one device, so the
# ranks share cuda:0, joined by gloo: every time here is one card
# time-sliced by SHARD_RANKS processes, not a tensor-parallel speed.
# qwen1.5-4b's widths at SHARD_DENSE_LAYERS layers in bf16 (20/20 heads
# of 128: 5/5 a rank through the paged kernel; d_ff 6912 and the vocab
# split 4 ways) on DENSE_TRAFFIC (uncut until sharded_train came: its 40
# layers took 75 s of the smoke's 1200; 8 layers until seq_cut came),
# then qwen3-moe-30b-a3b's widths at SHARD_MOE_LAYERS layers (32/4 heads:
# 8/1 a rank; 128 experts, 32 a rank) and deepseek-v3's at
# SHARD_MLA_LAYERS (its first dense-MLP layer and one MoE layer:
# n_dense_layers cut to 1; the latent rank 512 and krope 64, 128 and 16 a
# rank; MLA's absorbed decode is plain) in bf16 on SHARD_MOE_TRAFFIC,
# each beside rank 0's one-rank run of the same params (a gloo
# collective costs ~5 ms on the card's host, ~1 ms a barrier, and the
# capacity loop re-runs chunks: the moe models' depth and traffic are
# cut for the smoke's time, not for memory);
# then the serving invariants in fp32 (TF32 off) at SHARD_INV_LAYERS
# layers (deepseek-v3: its dense-MLP layer alone, as an fp32 MoE layer of
# 256 experts, 45 GB, does not fit beside the ranks' slices), 4 ranks
# against rank 0's one rank, apart from counted near-ties.
SHARD_RANKS = 4
# 8 and 4 until the seq_cut runs, then sharded_train's presets, took the
# smoke's time; 2 until the hybrid, audio and vlm runs did
SHARD_DENSE_LAYERS = 1
SHARD_MOE_LAYERS = 1
SHARD_MOE_TRAFFIC = dict(DENSE_TRAFFIC, requests=4, prompts=MOE_PROMPTS)
SHARD_MLA_LAYERS = 2
SHARD_INV_LAYERS = {"qwen1.5-4b": 1, "qwen3-moe-30b-a3b": 1,
                    "deepseek-v3-671b": 1}
SHARD_TIMEOUT_S = 900


def _shard_cfgs(fp32: bool) -> list:
    """(tag, cfg) of the phase's three models, in bf16 at the serve's
    depths or in fp32 at SHARD_INV_LAYERS; in a rehearsal their reduced
    configs (qwen3-moe with 4 KV heads, so they divide)."""
    from repro_torch.config import get_config, get_reduced_config
    out = []
    for arch, layers in (("qwen1.5-4b", SHARD_DENSE_LAYERS),
                         ("qwen3-moe-30b-a3b", SHARD_MOE_LAYERS),
                         ("deepseek-v3-671b", SHARD_MLA_LAYERS)):
        cfg = get_config(arch)
        n = SHARD_INV_LAYERS[arch] if fp32 else layers
        if REHEARSAL:
            cfg = get_reduced_config(arch)
            n = min(n, cfg.n_layers)
            if arch == "qwen3-moe-30b-a3b":
                cfg = cfg.with_(n_kv_heads=4)
        if cfg.moe is not None and cfg.moe.n_dense_layers:
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                    n_dense_layers=1))
        cfg = cfg.with_(n_layers=n)
        if fp32:
            cfg = cfg.with_(param_dtype="float32", activation_dtype="float32")
        out.append((arch.replace("-", "_").replace(".", "_"), cfg))
    return out


def _same_rid(r):
    """A copy of request ``r`` with its rid (``clone`` draws a new one:
    a run on one rank alone must not move that rank's rid counter)."""
    return dataclasses.replace(r, prompt=r.prompt.copy())


def _rank_params(mesh, cfg, device: str, baseline=None,
                 keep_full: bool = False, logical_map=None) -> tuple:
    """Rank by rank, the others waiting at a barrier: the full seeded
    params, ``baseline(full)`` on rank 0 (its one-rank run), this rank's
    slices (``launch.sharding.shard_params`` under ``logical_map``, by
    default the serving map), and the full copy freed
    before the next rank builds (kept on rank 0 with ``keep_full``), so
    the card holds one full copy at a time.  The cache is emptied before
    the slices are cut, so they take fresh blocks, not the build's
    freed temporaries'; where the full copy's freed blocks still leave
    more than COMPACT_BYTES reserved beside the slices (a freed block
    pinned by a slice in its segment), the slices are compacted through
    pinned host buffers (``_pinned``), not every rank's slices through
    pageable host memory, whether or not they need it.
    Returns (slices, the kept full params or None, the baseline's
    result, seconds)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    local = kept = base = None
    for r in range(mesh.size):
        if r == mesh.rank:
            full = T.init_params(cfg, seed=0, device=device)
            if r == 0 and baseline is not None:
                base = baseline(full)
            _free_quiet(device)
            local = SH.shard_params(cfg, full, mesh, logical_map)
            if r == 0 and keep_full:
                kept = full
            del full
            _free_quiet(device)
            if device == "cuda" and kept is None and (
                    torch.cuda.memory_reserved()
                    - torch.cuda.memory_allocated() > COMPACT_BYTES):
                host = _pinned(local)      # compacted: fresh blocks after
                local = None
                _free_quiet(device)
                local = tree_map(lambda t: t.to(device), host)
        mesh.barrier()
    return local, kept, base, time.perf_counter() - t0


# reserved bytes beside the allocated ones past which _rank_params
# compacts a rank's slices (deepseek-v3's 2-layer bf16 build left ~5 GB
# a rank without it, and the fourth rank's build ran out of memory)
COMPACT_BYTES = 1 << 30


def _pinned(tree):
    """A copy of ``tree``'s leaves in pinned host buffers."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True).copy_(t), tree)


def _run_timed(eng, reqs) -> tuple:
    """(results in request order, wall seconds) of ``eng.run``."""
    t0 = time.perf_counter()
    res = eng.run(reqs)
    sync()
    return [res[r.rid] for r in reqs], time.perf_counter() - t0


def _shard_serve(mesh, tag: str, cfg, device: str) -> dict:
    """One model in bf16 through ``ContinuousEngine(mesh=...)`` (dense
    on DENSE_TRAFFIC, moe on SHARD_MOE_TRAFFIC), rank 0's one-rank run
    of the same params first; paged
    launches exact (layers x decode steps, MLA: 0), the pool's measured
    bytes equal to the reported ``kv_bytes_per_device``; then the run's
    decode step CAPTURE_STEP once more on every rank with each paged
    launch held to its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.models import pspec as PS
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ContinuousEngine
    tr = DENSE_TRAFFIC if cfg.moe is None else SHARD_MOE_TRAFFIC
    reqs = _family_trace(cfg, tr["requests"], tr["prompts"], tr["max_new"],
                         tr["rate"], tr["seed"])
    kw = dict(n_slots=tr["slots"], max_seq=tr["max_seq"])

    def one_rank(full):
        eng = ContinuousEngine(cfg, full, **kw)
        res, wall = _run_timed(eng, [_same_rid(r) for r in reqs])
        n_tok = sum(len(r.tokens) for r in res)
        return dict(tokens=[r.tokens for r in res], wall_s=wall,
                    tokens_per_s=n_tok / wall, ticks=eng.clock,
                    decode_steps=eng.decode_steps_total,
                    retry_overflows=list(eng.moe_overflows))
    local, _, base, build_s = _rank_params(mesh, cfg, device, one_rank)
    mem = {}
    if device == "cuda":
        mem = dict(allocated_after_build=torch.cuda.memory_allocated(),
                   reserved_after_build=torch.cuda.memory_reserved())
        torch.cuda.reset_peak_memory_stats()
    eng = ContinuousEngine(cfg, local, mesh=mesh, **kw)
    mesh.barrier()
    ops.reset_launches()
    timer = (_StepTimes(capture_at=CAPTURE_STEP, chunks=True)
             if device == "cuda" else contextlib.nullcontext())
    with timer as steps:
        res, wall = _run_timed(eng, [r.clone() for r in reqs])
    counts = ops.launch_counts()
    stats = eng.kv_cache_stats()
    pool_bytes = sum(t.numel() * t.element_size()
                     for d in eng.slots.cache.values() for t in d.values())
    n_tok = sum(len(r.tokens) for r in res)
    mla = cfg.mla is not None
    want = 0 if mla else cfg.n_layers * eng.decode_steps_total
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, rank=mesh.rank,
               build_s=build_s, wall_s=wall, tokens_per_s=n_tok / wall,
               generated_tokens=n_tok, ticks=eng.clock,
               decode_steps=eng.decode_steps_total,
               paged_launches=counts["paged_decode_attention"],
               want_paged_launches=want, launches=counts,
               retry_overflows=list(eng.moe_overflows),
               tokens=[r.tokens for r in res], kv=stats,
               measured_pool_bytes=pool_bytes,
               drained=_drained(eng), one_rank=base,
               param_bytes_this_rank=_tree_bytes(local), **mem)
    if device == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["decode_s_per_step"] = (sum(steps.seconds("decode"))
                                    / max(eng.decode_steps_total, 1))
        held = {}
        p_, c_, cache, a, k = steps.captured
        with PS.mesh_rules(mesh, SH.SERVING_LOGICAL_MAP), \
                _held_to_plain(held):
            T.decode_step(p_, c_, cache, *a, **k)
            sync()
        out["held_to_plain"] = _shares(held)
    del eng, local
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _shard_invariants(mesh, tag: str, cfg, device: str, tmp: str) -> dict:
    """The serving invariants of one model in fp32 on the mesh: the 4-rank
    engine against rank 0's one-rank engine on the same params (greedy
    tokens identical apart from counted near-ties of the one-rank model;
    moe: the same overflow counts); for the dense model also a preempt
    -> spill -> resume round trip and a mid-flight checkpoint restored
    into ``clone_fresh()``, both against rank 0's solo run, and an
    unsharded engine refusing that checkpoint."""
    from repro_torch.serving.engine import ContinuousEngine
    from repro_torch.serving.scheduler import PreemptiveScheduler
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reqs = _family_trace(cfg, INV_REQUESTS, INV_PROMPTS, INV_MAX_NEW, 1.0,
                         MOE_SEED + 2)
    kw = dict(n_slots=4, max_seq=256)
    local, full, _, _ = _rank_params(mesh, cfg, device, keep_full=True)
    eng = ContinuousEngine(cfg, local, mesh=mesh, **kw)
    res, _ = _run_timed(eng, [r.clone() for r in reqs])
    got = [r.tokens for r in res]
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, tokens=got,
               retry_overflows=list(eng.moe_overflows),
               kv=eng.kv_cache_stats())
    round_trips = {}
    if cfg.moe is None:
        req = reqs[0]
        eng = ContinuousEngine(cfg, local, mesh=mesh, **kw)
        sched = PreemptiveScheduler(eng)
        probe = req.clone()
        sched.submit(probe)
        while not (eng.slots.decoding_slots()
                   and len(eng.slots.states[eng.slots.decoding_slots()[0]]
                           .emitted) >= 3):
            sched.step()
        sched.preempt(eng.slots.decoding_slots()[0], "spill")
        round_trips["preempt_resume"] = sched.run()[probe.rid].tokens
        check(sched.n_preemptions == 1 and sched.n_resumes == 1
              and _drained(eng), f"{tag}: sharded preempt/resume bookkeeping")
        eng = ContinuousEngine(cfg, local, mesh=mesh, **kw)
        sched = PreemptiveScheduler(eng)
        probe = req.clone()
        sched.submit(probe)
        for _ in range(4):
            sched.step()
        check(eng.slots.any_active(), f"{tag}: nothing in flight to "
              "checkpoint")
        path = os.path.join(tmp, f"{tag}.ckpt")
        out["checkpoint_bytes"] = sched.checkpoint(path)
        fresh = PreemptiveScheduler(eng.clone_fresh())
        fresh.restore(path)
        round_trips["checkpoint_restore"] = fresh.run()[probe.rid].tokens
    mesh.barrier()
    if mesh.rank == 0:
        one = ContinuousEngine(cfg, full, **kw)
        want, _ = _run_timed(one, [_same_rid(r) for r in reqs])
        prompts = [r.prompt for r in reqs]
        out["four_vs_one"] = _exact_or_near_ties(
            "4_ranks", got, [r.tokens for r in want], prompts, full, cfg)
        out["one_rank_overflows"] = list(one.moe_overflows)
        check(out["retry_overflows"] == out["one_rank_overflows"],
              f"{tag}: the ranks' overflow counts "
              f"{out['retry_overflows']} != one rank's "
              f"{out['one_rank_overflows']}")
        if round_trips:
            solo = ContinuousEngine(cfg, full, **kw)
            s_res, _ = _run_timed(solo, [_same_rid(reqs[0])])
            for name, toks in round_trips.items():
                out[name] = _exact_or_near_ties(
                    name, [toks], [s_res[0].tokens], [reqs[0].prompt], full,
                    cfg)
            try:
                PreemptiveScheduler(ContinuousEngine(cfg, full, **kw)) \
                    .restore(path)
                refused = None
            except RuntimeError as e:
                refused = str(e)
            check(refused is not None and "mesh" in refused,
                  f"{tag}: an unsharded engine restored the mesh checkpoint")
            out["unsharded_restore_refused"] = refused
    mesh.barrier()
    del eng, local, full
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _collective_ms(mesh, device: str, reps: int = 40) -> dict:
    """Host-clock ms of one of the mesh's collectives, each on this
    phase's shapes: a decode step's row-parallel sum (8 x 2560 fp32),
    a 64-token chunk's, the decode logits' exact gather (8 x 151936
    fp32) and a barrier."""
    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) / reps * 1e3
    out = {}
    for name, shape in (("all_reduce_8x2560", (8, 2560)),
                        ("all_reduce_64x2560", (64, 2560))):
        x = torch.ones(shape, device=device)
        out[name] = timed(lambda: mesh.all_reduce(x))
    local = torch.ones((8, 151936 // mesh.size), device=device)
    out["gather_8x151936"] = timed(lambda: mesh.gather(local, -1))
    out["barrier"] = timed(mesh.barrier)
    return out


# seq_cut (in sharded_serve's world): make_prefill_step, then greedy
# make_serve_step steps, on a SEQ_CUT_MESH (data, model) mesh of the same
# 4 ranks, for each model at its config's widths cut to SEQ_CUT_LAYERS
# under a serving preset: granite-20b (48/1 heads: the reference's rule
# cuts its cache's positions over "model") under baseline (FSDP over
# "data", each layer's weights gathered a step), qwen1.5-4b (20/20: the
# positions cut over "model", the heads too, so each layer gathers its
# heads' q, k and v first) under infer-tp, qwen3-moe-30b-a3b under
# infer-tp2 (its heads and 128 experts over all 4 ranks, the cache whole)
# and under ep (its experts over both axes, its positions over "model");
# then the hybrid, audio and vlm families: zamba2-7b at 7 layers (a unit
# of 6 Mamba2 blocks and the shared block, then a tail block; 112 SSM
# heads, 56 a rank over "model"; its 32 KV heads divide 16, so its cache
# is cut on its heads) under infer-tp, whisper-tiny uncut (4 + 4 layers;
# its self cache and its 1500-frame cross cache cut on their positions
# over "model", 750 frames a rank, its 6 heads too) under baseline, and
# qwen2-vl-2b at 2 layers (its 2 KV heads: the cache cut on its
# positions; M-RoPE decode positions) under infer-tp, with their side
# inputs cut on their rows with the tokens (SEQ_CUT_SIDE_SEED), their
# decode steps' collectives by axis, their cache bytes and their
# launches held to the dry-run's (``_dryrun_family_decode``); then the
# ssm family: xlstm-1.3b at 8 layers (one unit: 7 mLSTM blocks and an
# sLSTM block, cut on whole heads, 2 of 4 a rank over "model"; its state
# the rank's heads and rows) under infer-tp, which launches no kernel,
# held likewise.
# One seeded fp32 build a model: its fp32 params and their bf16 cast.
# bf16 on SEQ_CUT_BF16 = (rows, prompt, cache positions, decode steps),
# the last step's decode launches held to their plain version on every
# rank; then fp32 (TF32 off) on SEQ_CUT_FP32 against rank 0's one-rank
# run.  granite-20b takes SEQ_CUT_SIZES' bf16 steps: each of its steps
# gathers every layer's FSDP-cut weights through gloo on the host (1.8 s
# a step on the H100's host), and 2 steps already write on the second
# "model" rank and merge both.
SEQ_CUT_MESH = (2, 2)
SEQ_CUT_MODELS = (("granite-20b", "baseline"), ("qwen1.5-4b", "infer-tp"),
                  ("qwen3-moe-30b-a3b", "infer-tp2"),
                  ("qwen3-moe-30b-a3b", "ep"), ("zamba2-7b", "infer-tp"),
                  ("whisper-tiny", "baseline"), ("qwen2-vl-2b", "infer-tp"),
                  ("xlstm-1.3b", "infer-tp"))
SEQ_CUT_FAMILIES = ("hybrid", "audio", "vlm", "ssm")
SEQ_CUT_SIDE_SEED = 61
# layers a model (default 2; granite-20b's 1 since sharded_train's presets
# came: each of its layers gathers 0.8 GB of FSDP-cut bf16 weights a step;
# qwen3-moe's 1 since its ep run came: each MoE layer's prefill sends its
# tokens' blocks to the experts' owners through the host; qwen1.5-4b's 1
# since the hybrid, audio and vlm runs came; zamba2's 7: a unit of 6
# Mamba2 blocks and the shared block, then a tail block; whisper uncut;
# xlstm-1.3b's 8: one unit of 7 mLSTM blocks and an sLSTM block)
SEQ_CUT_LAYERS = {"granite-20b": 1, "qwen3-moe-30b-a3b": 1, "zamba2-7b": 7,
                  "whisper-tiny": 4, "qwen1.5-4b": 1, "xlstm-1.3b": 8}
SEQ_CUT_BF16 = (8, 1024, 2048, 16)
# bf16 sizes where not SEQ_CUT_BF16: 2 decode steps (4 until the hybrid,
# audio and vlm runs needed the time) for the runs that gather FSDP-cut
# weights over "data" every step, or exchange tokens with the experts'
# owners; qwen3-moe under ep (its
# 128 experts 32 a rank over both axes, the rows over "data", so each
# MoE layer exchanges its tokens with the experts' owners over "data")
# prefills 256-token prompts: the reference's prefill is drop-free at
# the static capacity C = the group's 8 x P tokens, so a rank dispatches
# (64 experts, C, d) bf16 to its column's experts: 0.54 GB at P = 256,
# 2.15 GB at 1024, where the dry-run predicts an 11.8 GB peak a rank,
# four of them on one card)
SEQ_CUT_SIZES = {("granite-20b", "baseline"): (8, 1024, 2048, 2),
                 ("qwen3-moe-30b-a3b", "ep"): (8, 256, 2048, 2),
                 # the hybrid, audio and vlm runs (cache positions past
                 # qwen2-vl's 256 patches): zamba2's prompts two SSD
                 # chunks, whisper's cache its serve phase's 448
                 ("zamba2-7b", "infer-tp"): (8, 512, 1024, 4),
                 ("whisper-tiny", "baseline"): (8, 64, 448, 4),
                 ("qwen2-vl-2b", "infer-tp"): (8, 256, 1024, 4),
                 # the xLSTM state has no positions: an 8 x 256 prefill
                 ("xlstm-1.3b", "infer-tp"): (8, 256, 512, 4)}
SEQ_CUT_FP32 = (8, 128, 256, 1)            # 2 steps until the new runs
SEQ_CUT_REHEARSAL = {False: (8, 32, 64, 4), True: (8, 16, 32, 3)}
# fp32 logits of the mesh against one rank's, atol and rtol: the merge
# of the ranks' partial softmaxes and the row-parallel sums add fp32
# roundings in another order (the CPU test's reduced configs: within
# 7e-6 of the reference)
SEQ_CUT_TOL = (1e-4, 1e-4)


def _seq_cut_cfg(arch: str, fp32: bool):
    from repro_torch.config import get_config, get_reduced_config
    cfg = get_reduced_config(arch) if REHEARSAL else get_config(arch)
    cfg = cfg.with_(n_layers=min(SEQ_CUT_LAYERS.get(arch, 2), cfg.n_layers))
    if fp32:
        cfg = cfg.with_(param_dtype="float32", activation_dtype="float32")
    return cfg


def _seq_cut_sizes(arch: str, preset: str, fp32: bool) -> tuple:
    """(rows, prompt, cache positions, decode steps) of a run."""
    if REHEARSAL:
        return SEQ_CUT_REHEARSAL[fp32]
    if fp32:
        return SEQ_CUT_FP32
    return SEQ_CUT_SIZES.get((arch, preset), SEQ_CUT_BF16)


def _seq_cut_prompts(cfg, rows: int, prompt: int) -> dict:
    """The run's global batch: seeded tokens, and the family's side input
    (0.02 x seeded normals, fp32 numpy: whisper's frames, qwen2-vl's
    patch embeddings)."""
    from repro_torch.config import side_input
    out = {"tokens": np.random.default_rng(MOE_SEED + 7).integers(
        0, cfg.vocab_size, (rows, prompt)).astype(np.int32)}
    side = side_input(cfg)
    if side is not None:
        out[side[0]] = (0.02 * np.random.default_rng(
            SEQ_CUT_SIDE_SEED).standard_normal(
                (rows, side[1], cfg.d_model))).astype(np.float32)
    return out


def _patches(cfg) -> int:
    """The positions ahead of the text: qwen2-vl's patches."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _path_launches(cfg) -> tuple:
    """(flash launches a prefill, SSD launches a prefill, contiguous
    decode launches a decode step) of a config's path: a layer's one
    of each (dense, moe, vlm); zamba2 one flash and one decode a unit
    and one SSD a Mamba2 block; whisper ``_side_launches``'; xLSTM
    none (its blocks are plain PyTorch, as the reference's)."""
    if cfg.family == "ssm":
        return 0, 0, 0
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return cfg.n_layers // k, cfg.n_layers, cfg.n_layers // k
    if cfg.family == "audio":
        flash, dec = _side_launches(cfg)
        return flash, 0, dec
    return cfg.n_layers, 0, cfg.n_layers


def _seq_cut_steps(cfg, params, batch, max_seq: int, steps: int,
                   device: str, mesh=None, lmap=None, held=None,
                   shapes=None) -> dict:
    """make_prefill_step on ``batch`` (the rank's rows of the tokens and
    the side input; its cache laid out for ``max_seq`` positions past
    qwen2-vl's patches), then ``steps`` greedy make_serve_step steps;
    one rank when ``mesh`` is None.  The launch
    counts are set to 0 just before and read just after.  Given
    ``held``, the last step runs under ``_held_to_plain(held, shapes)``:
    its launches, the path's own, each held to its plain version on its
    inputs.  Returns the tokens, the logits of the prefill's last
    position and of each step, each step's collectives by axis (and by
    kind) and host ms (synced), the cache and its bytes, the launches
    and the peak bytes of the steps."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves_with_path
    on = dict(mesh=mesh, logical_map=lmap) if mesh is not None else {}
    P = _patches(cfg)
    prefill = make_prefill_step(cfg, moe_dispatch="scatter",
                                max_seq=P + max_seq, **on)
    step = make_serve_step(cfg, **on)
    inputs = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    prompt = batch["tokens"].shape[1]
    if mesh is not None:
        mesh.barrier()
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs)
    sync()
    prefill_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out_logits, out_tokens, ms, coll, kinds = ([logits[:, 0].float()], [],
                                               [], [], [])
    nxt = logits[:, 0].argmax(-1)
    for t in range(steps):
        out_tokens.append(nxt)
        if mesh is not None:
            mesh.reset_counts()
        hold = (_held_to_plain(held, shapes)
                if held is not None and t == steps - 1
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with hold:
            logits, cache = step(params, cache,
                                 nxt[:, None].to(torch.int32),
                                 P + prompt + t)
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if mesh is not None:
            coll.append(dict(mesh.counts))
            kinds.append(_kinds(mesh))
        out_logits.append(logits[:, 0].float())
        nxt = logits[:, 0].argmax(-1)
    launches = ops.launch_counts()
    return dict(tokens=torch.stack(out_tokens, 1).cpu().numpy(),
                logits=torch.stack(out_logits, 1), step_ms=ms,
                collectives=coll, kinds=kinds, prefill_s=prefill_s,
                launches=launches,
                cache_bytes=_tree_bytes(cache),
                cache_shapes={"/".join(p): list(t.shape) for p, t in
                              tree_leaves_with_path(cache)},
                peak_bytes=(torch.cuda.max_memory_allocated()
                            if device == "cuda" else None))


def _seq_cut_serve(mesh, arch: str, preset: str, device: str) -> dict:
    """One model of seq_cut on this rank (see SEQ_CUT_MESH).  One seeded
    fp32 build (``_rank_params``; rank 0 runs both one-rank runs on the
    full params first: bf16 on their cast, then fp32), the bf16 slices
    cast from the rank's fp32 ones.  The fp32 run and each of its
    logits' share of SEQ_CUT_TOL against rank 0's one-rank logits
    (broadcast); then, the fp32 slices freed, the bf16 run (its
    readings; its last step's launches held to their plain versions,
    with their shapes)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    lmap = SH.train_map(preset)
    out = dict(arch=arch, preset=preset, rank=mesh.rank,
               coord=dict(mesh.coord))
    cfgs = {fp32: _seq_cut_cfg(arch, fp32) for fp32 in (False, True)}
    like = T.param_shapes(cfgs[False])

    def to_bf16(tree):
        return tree_map(lambda t, m: t.to(m.dtype), tree, like)

    prompts = {fp32: _seq_cut_prompts(
        cfgs[fp32], *_seq_cut_sizes(arch, preset, fp32)[:2])
        for fp32 in (False, True)}

    def run(fp32, params, tokens, on_mesh=False, **kw):
        _, _, S, n = _seq_cut_sizes(arch, preset, fp32)
        ctx = _no_tf32() if fp32 else contextlib.nullcontext()
        with ctx:
            return _seq_cut_steps(cfgs[fp32], params, tokens, S, n, device,
                                  *((mesh, lmap) if on_mesh else ()), **kw)

    def one_rank(full):
        return {fp32: run(fp32, full if fp32 else to_bf16(full),
                          prompts[fp32]) for fp32 in (False, True)}
    local32, _, base, build_s = _rank_params(mesh, cfgs[True], device,
                                             one_rank, logical_map=lmap)
    for fp32 in (True, False):         # fp32 first: bf16's peak holds no fp32
        cfg = cfgs[fp32]
        B, P, S, n = _seq_cut_sizes(arch, preset, fp32)
        rows = SH.shard_batch(prompts[fp32], mesh, lmap)
        toks, n_rows = prompts[fp32]["tokens"], len(rows["tokens"])
        first = next(i for i in range(0, B, n_rows)
                     if np.array_equal(toks[i:i + n_rows], rows["tokens"]))
        local = local32 if fp32 else to_bf16(local32)
        if not fp32:
            local32 = None
            _free_quiet(device)
        held, shapes = {}, {}
        r = (run(fp32, local, rows, True) if fp32 else
             run(fp32, local, rows, True, held=held, shapes=shapes))
        whole = SH.shard_cache(cfg, T.init_cache(
            cfg, B, _patches(cfg) + S, device="meta"), mesh, lmap)
        rec = dict(rank=mesh.rank, n_layers=cfg.n_layers,
                   dtype=cfg.param_dtype, sizes=[B, P, S, n],
                   rows=[first, n_rows], tokens=r["tokens"],
                   step_ms=r["step_ms"], prefill_s=r["prefill_s"],
                   collectives=r["collectives"], kinds=r["kinds"],
                   launches=r["launches"], cache_bytes=r["cache_bytes"],
                   rule_cache_bytes=_tree_bytes(whole),
                   cache_shapes=r["cache_shapes"],
                   peak_bytes=r["peak_bytes"], build_s=build_s,
                   param_bytes_this_rank=_tree_bytes(local))
        if fp32:
            want = (base[True]["logits"] if mesh.rank == 0 else
                    torch.empty((B, n + 1, cfg.vocab_size),
                                dtype=torch.float32, device=device))
            want = mesh.broadcast(want.contiguous(), 0)
            want = want[first:first + n_rows]
            atol, rtol = SEQ_CUT_TOL
            rec.update(max_abs_err=_max_excess(r["logits"], want,
                                               atol, rtol)[0],
                       share_of_tolerance=_share_of_tolerance(
                           r["logits"], want, atol, rtol),
                       one_rank_tokens=(base[True]["tokens"]
                                        if mesh.rank == 0 else None))
        else:
            rec.update(held_to_plain=_shares(held),
                       held_shapes={k: sorted(v) for k, v in shapes.items()})
            if mesh.rank == 0:
                one = base[False]
                rec["one_rank"] = dict(tokens=one["tokens"],
                                       step_ms=one["step_ms"],
                                       prefill_s=one["prefill_s"])
        rec["cfg"] = cfg
        out["fp32" if fp32 else "bf16"] = rec
        del local, r
        _free_quiet(device)
    del base
    _free_quiet(device)
    return out


def _seq_cut_rank(device) -> dict:
    """Every model of seq_cut on this rank of a SEQ_CUT_MESH mesh of the
    world (every rank builds it) on ``device``."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*SEQ_CUT_MESH, device=device)
    out = {}
    for arch, preset in SEQ_CUT_MODELS:
        t0 = time.perf_counter()
        out[f"{arch} {preset}"] = _seq_cut_serve(mesh, arch, preset,
                                                 mesh.device.type)
        out[f"{arch} {preset}"]["seconds"] = time.perf_counter() - t0
    return out


def _sharded_rank(mesh, tmp: str) -> dict:
    """This rank's part of sharded_serve (its readings)."""
    device = mesh.device.type
    out = {"rank": mesh.rank, "collective_ms": _collective_ms(mesh, device)}
    for tag, cfg in _shard_cfgs(fp32=False):
        out[tag] = _shard_serve(mesh, tag, cfg, device)
    for tag, cfg in _shard_cfgs(fp32=True):
        out[f"{tag}_invariants"] = _shard_invariants(mesh, tag, cfg, device,
                                                     tmp)
    t0 = time.perf_counter()
    out["seq_cut"] = _seq_cut_rank(mesh.device)
    out["seq_cut_s"] = time.perf_counter() - t0
    return out


def _lse_shapes(rec: dict) -> set:
    """The (B, S, H, Hkv, D) of a run's held decode launches with the
    lse."""
    return {(q[0], k[1], q[1], k[2], q[2])
            for q, k, lse in rec["held_shapes"].get("decode_attention", ())
            if lse}


def _check_seq_cut(ranks: list, device: str) -> dict:
    """seq_cut's checks over every rank's readings, and its line: ranks
    holding the same rows emit the same tokens; each rank's decode
    launches are a step's (``_path_launches``: layers, zamba2's units,
    whisper's self and cross) x steps, its flash and SSD launches a
    prefill's; its cache's bytes are the rule's (``shard_cache`` of a
    whole cache); every rank's held bf16 step: its decode launches each
    within its bound of the plain version, with the lse where the rule
    cuts the positions, at a DECODE_LSE shape (the decode phase's timed
    rows); the fp32 logits within SEQ_CUT_TOL of one rank's; the
    hybrid, audio and vlm runs' decode steps as the dry-run predicts
    them (``_dryrun_family_decode``).  Returns the launches, all ranks
    summed, and the dry-run's readings of granite-20b's decode step
    (rank 0's)."""
    total, lines, readings = {}, {}, None
    for arch, preset in SEQ_CUT_MODELS:
        tag = f"{arch} {preset}"
        rows = [r["seq_cut"][tag] for r in ranks]
        for kind in ("bf16", "fp32"):
            recs = [r[kind] for r in rows]
            cfg = recs[0]["cfg"]
            L = cfg.n_layers
            n = recs[0]["sizes"][3]
            flash, ssd, dec = _path_launches(cfg)
            for a in recs:
                for b in recs:
                    if a["rows"] == b["rows"]:
                        check(np.array_equal(a["tokens"], b["tokens"]),
                              f"seq_cut {tag} {kind}: ranks of the same "
                              "rows emit different tokens")
                check(a["cache_bytes"] == a["rule_cache_bytes"],
                      f"seq_cut {tag} {kind}: cache {a['cache_bytes']} "
                      f"bytes, the rule's {a['rule_cache_bytes']}")
                if device == "cuda":
                    got = tuple(a["launches"][k] for k in (
                        "decode_attention", "flash_attention",
                        "ssm_chunk_scan"))
                    want = (dec * n, flash, ssd)
                    check(got == want, f"seq_cut {tag} {kind}: decode, "
                          f"flash and SSD launches {got}, want {want}")
                if kind == "fp32":
                    check(a["share_of_tolerance"] <= 1.0,
                          f"seq_cut {tag} fp32: logits err "
                          f"{a['max_abs_err']} over {SEQ_CUT_TOL} of one "
                          "rank's")
                elif device == "cuda" and dec:
                    what = f"seq_cut {tag} bf16 rank {a['rank']}"
                    held = a["held_to_plain"].get("decode_attention", {})
                    check(held.get("launches") == dec, f"{what}: "
                          f"{held.get('launches')} decode launches held "
                          f"in a step, want {dec}")
                    _check_held(a, what)
                    cut = a["cache_shapes"]
                    cut = next(v for k, v in cut.items()
                               if k.endswith("k"))[2] < (
                                   _patches(cfg) + a["sizes"][2])
                    lse = _lse_shapes(a)
                    timed = (lse if REHEARSAL else
                             {tuple(sh) for sh, _ in DECODE_LSE})
                    check(bool(lse) == cut and lse <= timed,
                          f"{what}: decode launches with the lse at "
                          f"{sorted(lse)}, the positions "
                          f"{'cut' if cut else 'whole'}; DECODE_LSE "
                          f"times {[sh for sh, _ in DECODE_LSE]}")
            if kind == "bf16":
                for a in recs:
                    for k, v in a["launches"].items():
                        total[k] = total.get(k, 0) + v
            r0 = recs[0]
            line = dict(preset=preset, n_layers=L, dtype=r0["dtype"],
                        rows_prompt_cache_steps=r0["sizes"],
                        cache_bytes_per_rank=[a["cache_bytes"] for a in recs],
                        rule_cache_bytes=r0["rule_cache_bytes"],
                        cache_shapes=r0["cache_shapes"],
                        launches=[a["launches"] for a in recs],
                        collectives_per_step=r0["collectives"][-1]
                        if r0["collectives"] else None,
                        step_ms_median=[float(np.median(a["step_ms"]))
                                        for a in recs],
                        prefill_s=[a["prefill_s"] for a in recs],
                        peak_bytes=[a["peak_bytes"] for a in recs],
                        param_bytes_this_rank=[a["param_bytes_this_rank"]
                                               for a in recs],
                        build_s=[a["build_s"] for a in recs],
                        rows=[a["rows"] for a in recs])
            if kind == "bf16":
                line.update(held_to_plain=[a["held_to_plain"] for a in recs],
                            lse_launch_shapes=sorted(
                                set().union(*map(_lse_shapes, recs))))
            if kind == "fp32":
                line.update(max_abs_err=[a["max_abs_err"] for a in recs],
                            share_of_tolerance=[a["share_of_tolerance"]
                                                for a in recs],
                            tolerance=SEQ_CUT_TOL)
                one = r0["one_rank_tokens"]
                line["tokens_equal_to_one_rank"] = sum(
                    np.array_equal(a["tokens"][i],
                                   one[a["rows"][0] + i])
                    for a in recs for i in range(a["rows"][1]))
            else:
                one = r0["one_rank"]
                line.update(one_rank_step_ms_median=float(
                    np.median(one["step_ms"])),
                            one_rank_prefill_s=one["prefill_s"],
                            tokens_equal_to_one_rank=sum(
                                np.array_equal(a["tokens"][i],
                                               one["tokens"][a["rows"][0]
                                                             + i])
                                for a in recs for i in range(a["rows"][1])))
                if cfg.family in SEQ_CUT_FAMILIES:
                    line["dryrun"] = _dryrun_family_decode(
                        arch, preset, cfg, recs, dec, device)
                if arch == "granite-20b":
                    readings = dict(
                        cfg=cfg, batch=r0["sizes"][0],
                        cache_len=r0["sizes"][2],
                        decode_per_step=L,
                        collectives_per_step=r0["collectives"][-1],
                        cache_bytes=r0["cache_bytes"],
                        decode_step_ms=float(np.median(r0["step_ms"])),
                        peak_bytes=r0["peak_bytes"])
            lines[f"{tag} {kind}"] = line
    emit("seq_cut", mesh=list(SEQ_CUT_MESH), ranks=SHARD_RANKS,
         backend="gloo", models=lines,
         seconds=[r["seq_cut_s"] for r in ranks],
         seconds_by_model={f"{a} {p}": [r["seq_cut"][f"{a} {p}"]["seconds"]
                                        for r in ranks]
                           for a, p in SEQ_CUT_MODELS})
    return total, readings


def _dryrun_family_decode(arch: str, preset: str, cfg, recs: list,
                          dec: int, device: str) -> dict:
    """The dry-run of a hybrid, ssm, audio or vlm seq_cut model's decode
    step (``dryrun_one``: rank 0 of a SEQ_CUT_MESH ``CountingMesh`` under the
    run's preset, gloo's path on the ranks' tensors) held to the run:
    every rank's every step's collectives by axis and kind, count and
    bytes, the Mamba2 norm's all-reduces and the merges' gathers among
    them; every rank's cache bytes; its decode launches a step."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    B, _, S, _ = recs[0]["sizes"]
    res = dryrun_one(arch, ShapeSpec("seq_cut", _patches(cfg) + S, B,
                                     "decode"),
                     mesh=SEQ_CUT_MESH, sharding=preset, cfg=cfg,
                     backend="gloo" if device == "cuda" else "gloo-cpu",
                     verbose=False)
    kinds = _kinds(res["collectives_by_axis"])
    what = f"dryrun seq_cut {arch} {preset}"
    for a in recs:
        for k in a["kinds"]:
            check(k == kinds, f"{what} rank {a['rank']}: collectives {k}, "
                  f"the dry-run's {kinds}")
        check(a["cache_bytes"] == res["cache_bytes"], f"{what}: cache "
              f"{a['cache_bytes']} bytes, the dry-run's "
              f"{res['cache_bytes']}")
    check(res["kernels"] == ({"decode_attention": dec} if dec else {}),
          f"{what}: {res['kernels']} a step predicted, {dec} decode "
          "launches")
    return dict(kinds_per_step=kinds, cache_bytes=res["cache_bytes"],
                kernels=res["kernels"], trace_s=res["trace_s"])


def _mesh_rank(mesh, rehearsal: bool, tmp: str) -> dict:
    """One rank of the mesh phases, all in one world (one spawn):
    sharded_serve's part (``_sharded_rank``, seq_cut's among it), then
    sharded_train's (``_sharded_train_rank``), then the pod run's (the
    same on POD_TRAIN_MESH); each part's seconds."""
    global REHEARSAL
    REHEARSAL = rehearsal
    t0 = time.perf_counter()
    serve = _sharded_rank(mesh, tmp)
    _free_quiet(mesh.device.type)
    t1 = time.perf_counter()
    train = _sharded_train_rank(mesh)
    _free_quiet(mesh.device.type)
    t2 = time.perf_counter()
    pod = _sharded_train_rank(mesh, POD_TRAIN_RUNS, POD_TRAIN_MESH)
    return dict(serve=serve, train=train, pod=pod, serve_s=t1 - t0,
                train_s=t2 - t1, pod_s=time.perf_counter() - t2)


def phase_mesh(device: str = "cuda") -> tuple:
    """``_mesh_rank`` on SHARD_RANKS processes (``launch.mesh.spawn``,
    gloo, every rank on ``device``; a rank that raises makes the phase
    raise), then sharded_serve's checks (``_check_sharded_serve``),
    sharded_train's and the pod run's (``_check_sharded_train``).
    Returns (sharded_serve's launches, seq_cut's readings,
    sharded_train's result, the pod run's launches)."""
    from repro_torch.launch.mesh import spawn
    _free("before the mesh phases")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sharded_serve_") as tmp:
        ranks = spawn(_mesh_rank, SHARD_RANKS, REHEARSAL, tmp,
                      backend="gloo", device=device, threads=1,
                      timeout_s=SHARD_TIMEOUT_S)
    emit("mesh_world", ranks=SHARD_RANKS, seconds=time.perf_counter() - t0,
         serve_s=[r["serve_s"] for r in ranks],
         train_s=[r["train_s"] for r in ranks],
         pod_s=[r["pod_s"] for r in ranks])
    serve, seq_cut = _check_sharded_serve(
        [r["serve"] for r in ranks], device,
        max(r["serve_s"] for r in ranks))
    train = _check_sharded_train([r["train"] for r in ranks], device,
                                 max(r["train_s"] for r in ranks))
    pod = _check_sharded_train([r["pod"] for r in ranks], device,
                               max(r["pod_s"] for r in ranks),
                               POD_TRAIN_RUNS, POD_TRAIN_MESH, "pod_train")
    pod.pop("readings")
    return serve, seq_cut, train, pod


def _check_sharded_serve(ranks: list, device: str, seconds: float) -> tuple:
    """sharded_serve's checks of its ranks' readings (``_sharded_rank``,
    each rank's; ``seconds``: the slowest rank's part): every rank's
    tokens identical, ``n_kv_shards`` and ``n_expert_shards`` =
    SHARD_RANKS, ``experts_per_device``, each rank's exact paged
    launches and its measured pool bytes equal to the reported
    ``kv_bytes_per_device``, then seq_cut's (``_check_seq_cut``); emits
    one line per model and one for the phase.  Returns the kernels'
    launches in the bf16 serves and seq_cut's bf16 runs, all ranks
    summed, and seq_cut's granite-20b readings for the dry-run."""
    total = {}
    for tag, cfg in _shard_cfgs(fp32=False):
        rows = [r[tag] for r in ranks]
        r0 = rows[0]
        same = all(all(np.array_equal(a, b) for a, b in
                       zip(r["tokens"], r0["tokens"])) for r in rows)
        check(same, f"sharded {tag}: the ranks' tokens differ")
        kv = r0["kv"]
        check(all(r["kv"]["kv_bytes_per_device"] == r["measured_pool_bytes"]
                  for r in rows) and all(r["drained"] for r in rows),
              f"sharded {tag}: measured pool bytes or drain")
        check(kv["n_kv_shards"] == SHARD_RANKS
              and kv["kv_bytes_per_device"] * SHARD_RANKS
              == kv["kv_cache_bytes"],
              f"sharded {tag}: pool not cut {SHARD_RANKS} ways: {kv}")
        if cfg.moe is not None:
            E = cfg.moe.n_experts
            check(kv["n_expert_shards"] == SHARD_RANKS
                  and kv["experts_per_device"] == E // SHARD_RANKS,
                  f"sharded {tag}: experts {kv}")
        if device == "cuda":
            check(all(r["paged_launches"] == r["want_paged_launches"]
                      for r in rows), f"sharded {tag}: paged launches "
                  f"{[r['paged_launches'] for r in rows]} != "
                  f"{r0['want_paged_launches']} a rank")
            if cfg.mla is None:
                for r in rows:
                    _check_held({"held_to_plain": r["held_to_plain"]},
                                f"sharded {tag} rank {r['rank']}")
        for r in rows:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
        one = r0["one_rank"]
        emit(f"sharded_{tag}", arch=cfg.name, n_layers=cfg.n_layers,
             param_dtype=cfg.param_dtype, ranks=SHARD_RANKS,
             backend="gloo", all_ranks_same_tokens=same,
             one_rank=dict(tokens_per_s=one["tokens_per_s"],
                           wall_s=one["wall_s"], ticks=one["ticks"],
                           decode_steps=one["decode_steps"],
                           retry_overflows=one["retry_overflows"]),
             sequences_equal_to_one_rank=sum(
                 np.array_equal(a, b)
                 for a, b in zip(r0["tokens"], one["tokens"])),
             n_sequences=len(r0["tokens"]),
             per_rank=[{k: r.get(k) for k in (
                 "rank", "build_s", "wall_s", "tokens_per_s", "ticks",
                 "decode_steps", "paged_launches", "want_paged_launches",
                 "measured_pool_bytes", "peak_mem_bytes",
                 "param_bytes_this_rank", "allocated_after_build",
                 "reserved_after_build", "decode_s_per_step",
                 "retry_overflows", "held_to_plain")} for r in rows],
             kv={k: kv[k] for k in (
                 "kv_cache_bytes", "kv_bytes_per_device", "n_kv_shards",
                 "pages_in_use_per_device", "peak_pages_in_use_per_device",
                 "peak_pages_in_use", "mesh_devices", "mesh_axes",
                 "n_expert_shards", "experts_per_device")})
    inv = {}
    for tag, cfg in _shard_cfgs(fp32=True):
        rows = [r[f"{tag}_invariants"] for r in ranks]
        r0 = rows[0]
        check(all(all(np.array_equal(a, b) for a, b in
                      zip(r["tokens"], r0["tokens"])) for r in rows),
              f"sharded {tag} fp32: the ranks' tokens differ")
        inv[tag] = {k: v for k, v in r0.items()
                    if k not in ("tokens", "kv")}
        inv[tag]["n_kv_shards"] = r0["kv"]["n_kv_shards"]
    emit("sharded_invariants", ranks=SHARD_RANKS, tf32=False, **inv)
    seq_total, readings = _check_seq_cut(ranks, device)
    for k, v in seq_total.items():
        total[k] = total.get(k, 0) + v
    emit("sharded_serve", ranks=SHARD_RANKS, backend="gloo",
         device=device, launches_all_ranks=total,
         collective_ms=[r["collective_ms"] for r in ranks],
         seconds=seconds)
    return total, readings


# sharded_train: ``make_train_step(mesh=...)`` on SHARD_RANKS ranks on
# cuda:0 under gloo, a SHARD_TRAIN_MESH (data, model) mesh under the
# reference's presets (baseline: tensor parallel over "model", FSDP and
# the batch over "data"; then SHARD_TRAIN_RUNS' others), on
# train_smollm's data (TokenStream seed 0, TRAIN_BATCH x TRAIN_SEQ, lr
# TRAIN_LR, TRAIN_WARMUP warmup steps): bf16 steps of each model at its
# config's widths, cut to the depth beside it (gloo's collectives cross
# the host), then one fp32 step (TF32 off) at the check depth against
# one rank's.  The card
# is one GPU: its 4 ranks are 4 processes time-sliced on it, so no time
# here is a data- or tensor-parallel speed.
# the dryrun phase's time limit
DRYRUN_LIMIT_S = 30.0
SHARD_TRAIN_MESH = (2, 2)
# baseline's bf16 steps (5 until the smoke needed the time; the first
# 4 steps' losses, the same on the card in every run, still fall)
SHARD_TRAIN_STEPS = 4
# (arch, bf16 layers, fp32 check layers, preset, bf16 steps), an arch's
# runs together (its params are built once for all of them, and its
# one-rank fp32 step run once): baseline first (its one-rank bf16 run
# is every preset's yardstick: the same params and batches), then
# training under infer-tp (no FSDP) and infer-tp2 (every weight over
# both axes, the batch whole), and the presets the MoE's exchange
# opened: ep (qwen3-moe's 128 experts 32 a rank over both axes, the
# tokens over "data": an all-to-all over "data" with each expert's
# owner), dp (the experts 64 a rank over "model", FSDP-cut over "data",
# the tokens over both axes: an all-to-all over "model"), 1 bf16 step
# each (2 until the hybrid, audio and vlm runs needed the time).
# qwen3-moe at 1 layer (2 until the smoke needed the time: each
# layer's experts, 1.2 GB of bf16, cross the host in every step's FSDP
# gathers and gradient sums); qwen1.5-4b at 2 bf16 layers (4 until the
# hybrid, audio and vlm runs needed the time).  Then the hybrid, audio
# and vlm families
# under baseline, 2 bf16 steps and the fp32 step each, their side inputs
# cut on their rows: zamba2-7b at 7 layers (a unit of 6 Mamba2 blocks cut
# on whole heads, 56 of 112 a rank, and the shared block, then a tail
# block; SSD and flash launched on every rank), whisper-tiny uncut,
# qwen2-vl-2b at 2 layers; each step's collectives by axis and kind, its
# launches and the slices' bytes held to the dry-run's; then the ssm
# family: xlstm-1.3b at 8 layers (one unit: 7 mLSTM blocks and an sLSTM
# block on whole heads, 2 of 4 a rank over "model", FSDP over "data")
# under baseline, likewise
SHARD_TRAIN_RUNS = (("qwen1.5-4b", 2, 2, "baseline", SHARD_TRAIN_STEPS),
                    ("qwen1.5-4b", 2, 2, "infer-tp", 1),
                    ("qwen1.5-4b", 2, 2, "infer-tp2", 1),
                    ("qwen3-moe-30b-a3b", 1, 1, "baseline",
                     SHARD_TRAIN_STEPS),
                    ("qwen3-moe-30b-a3b", 1, 1, "ep", 1),
                    ("qwen3-moe-30b-a3b", 1, 1, "dp", 1),
                    ("zamba2-7b", 7, 7, "baseline", 2),
                    ("whisper-tiny", 4, 4, "baseline", 2),
                    ("qwen2-vl-2b", 2, 2, "baseline", 2),
                    ("xlstm-1.3b", 8, 8, "baseline", 2))
# the pod run (in the same world, after sharded_train): a (pod, data,
# model) mesh of the 4 ranks, POD_TRAIN_MESH, on which the reference's
# default map cuts FSDP and the batch over ("pod", "data"): over "pod"
# alone here (its "data" is one rank); qwen1.5-4b at 1 layer under
# baseline, 1 bf16 step and the fp32 step against one rank, each step's
# collectives by axes and kind and the slices' bytes held to the
# dry-run's ``CountingMesh`` of the same shape
POD_TRAIN_MESH = (2, 1, 2)
POD_TRAIN_RUNS = (("qwen1.5-4b", 1, 1, "baseline", 1),)
# bf16: each step's loss on the mesh within SHARD_TRAIN_LOSS_FACTOR x
# bf16's own error on one rank: the largest gap, over the steps, between
# the one-rank run's bf16 loss and the fp32 loss of the same params and
# batch (upcast, forward only, TF32 off), as tests/test_torch_bf16.py
# takes the reference's own bf16 error.  The mesh's bf16 error is a few
# times one rank's: each row-parallel product rounds its partials to bf16
# before their sum, and the MoE routes (and drops) on those sums (on an
# H100 80GB HBM3 at 700 W, same params: qwen3-moe's step-0 loss 5.0e-3
# off one rank's, whose own bf16 error was 1.4e-3)
SHARD_TRAIN_LOSS_FACTOR = 8.0
# fp32, one step, tests/test_torch_mesh_training.py's rules: params
# within SHARD_TRAIN_PARAM_ATOL (the unembedding weight's second value)
# where the one-rank gradient scale sqrt(vhat) >= SHARD_TRAIN_SENSITIVE,
# within 2 x lr everywhere (AdamW turns a last-bit difference of a
# near-zero gradient into a step); mu and nu within
# SHARD_TRAIN_MOMENT_RTOL x (the leaf's largest entry + their own), plus
# one and two bf16 ulps of the largest entry on the unembedding weight
# (its gradient is rounded to bf16 on the way back).  A key bias b_k
# takes no gradient in exact arithmetic (the softmax is invariant to a
# shift common to a query's scores): its moments are rounding noise
# (whisper-tiny's ~1e-11 beside b_q's ~1e-4, on the CPU), different on
# the mesh and on one rank, so the "largest entry" there is the same
# layer's query bias's (``_fp32_share``'s ``big``)
SHARD_TRAIN_PARAM_ATOL = (1e-5, 1e-4)
SHARD_TRAIN_SENSITIVE = 1e-5
SHARD_TRAIN_MOMENT_RTOL = 1e-4
# zamba2-7b's run (the hybrid family): its random weights drive the
# Mamba2 activations to ~1e6 (SSD_PATH_FACTOR's note), so fp32 sums in
# another order err ~10x the dense configs': after the fp32 step at 7
# layers its moments sat up to 3.3e-4 of their leaves' largest entries
# off one rank's (the tail's A_log; its conv_b, conv_w, in_proj and
# out_proj 0.6-1.1e-4), on an H100 80GB HBM3 at 700 W (the slice that
# added the hybrid family on a mesh, its calls B and C); the reduced
# config on the CPU 1.8e-5.  A head's share read from another head's, or
# a partial left unsummed over a mesh axis, is off by O(1) of it.  The
# ssm family (xLSTM) takes it too: at 8 layers its mLSTM moments sat up
# to 4.3e-4 (mu) and 7.5e-4 (nu) of their leaves' largest entries off
# one rank's (the per-head norm's scale, w_q, w_k, conv_w; the
# exponential gates' stabilizer amplifies fp32 sums in another order),
# with the loss equal to 1e-7 and the gradient norm to 4.7e-5 of one
# rank's and every param within its tolerance (the slice that added the
# ssm family on a mesh, its call 3); the reduced config on the CPU within
# 5e-5 after a step, and a gate's gradient left unsummed over the heads'
# axes O(1) off there
SHARD_TRAIN_HYBRID_MOMENT_RTOL = 1e-3


def _shard_train_cfg(arch: str, layers: int, fp32: bool = False):
    """``arch`` at its widths cut to ``layers`` (a rehearsal: its reduced
    config), in bf16 or fp32."""
    from repro_torch.config import get_config, get_reduced_config
    cfg = get_reduced_config(arch) if REHEARSAL else get_config(arch)
    cfg = cfg.with_(n_layers=min(layers, cfg.n_layers))
    if fp32:
        cfg = cfg.with_(param_dtype="float32", activation_dtype="float32")
    return cfg


def _train_steps(step, params, state, batches, device: str, mesh=None,
                 lmap=None) -> tuple:
    """``step`` over the global ``batches`` (this rank's rows of each on
    a ``mesh``).  Returns (params, state, a row a step: the metrics, the
    step's ms between CUDA events (host clock on the cpu), this rank's
    dropped MoE routings, the mesh's collectives by axis)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import moe as M
    rows = []
    for batch in batches:
        if mesh is not None:
            batch = SH.shard_batch(batch, mesh, lmap)
            mesh.reset_counts()
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        mark, marks = _step_events(device)
        mark()
        with M.drop_counts() as drops:
            params, state, m = step(params, state, batch)
        mark()
        sync()
        rows.append(dict({k: float(v) for k, v in m.items()},
                         ms=_span_ms(*marks),
                         drops=sum(int(v) for v in drops.values()),
                         collectives=None if mesh is None
                         else dict(mesh.counts),
                         kinds=None if mesh is None else _kinds(mesh)))
    return params, state, rows


def _kinds(mesh) -> dict:
    """A mesh's collectives since its counts were reset (or a dry-run
    result's ``collectives_by_axis``), by axis and kind: {axis: {kind:
    [count, result bytes]}}, the kinds issued."""
    by_axis = mesh if isinstance(mesh, dict) else mesh.by_axis
    return {a: {k: [v["count"], v["bytes"]] for k, v in kinds.items()
                if k != "link_bytes" and v["count"]}
            for a, kinds in by_axis.items()}


def _run_tag(arch: str, preset: str) -> str:
    tag = arch.replace("-", "_").replace(".", "_")
    return tag if preset == "baseline" else f"{tag}_{preset.replace('-', '_')}"


def _plan_bytes(cfg, mesh, lmap, itemsize=None) -> int:
    """The bytes a rank's slices of a params-shaped tree take by the
    rule (``sharding.param_plan`` on the whole shapes), each entry of
    ``itemsize`` bytes (None: the param's own type)."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves_with_path
    shapes = T.param_shapes(cfg, max_seq=_train_seq(cfg))
    plan = SH.param_plan(cfg, shapes, mesh, lmap)
    return sum(int(np.prod(SH.local_shape(t.shape, *plan[p])))
               * (itemsize or t.element_size())
               for p, t in tree_leaves_with_path(shapes))


def _train_opt(warmup: int = TRAIN_WARMUP):
    from repro_torch.training import optim
    return optim.OptimConfig(lr=TRAIN_LR, warmup_steps=warmup,
                             total_steps=TRAIN_STEPS)


def _train_batches(cfg, steps: int) -> list:
    """train_smollm's first ``steps`` global batches at ``cfg``'s vocab
    ({"tokens": numpy}), with the family's side input where it has one
    (0.02 x seeded normals, fp32 numpy: whisper's frames, qwen2-vl's
    patch embeddings, ahead of the TRAIN_SEQ text tokens)."""
    from repro_torch.config import side_input
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH))
    side = side_input(cfg)
    out = []
    for s in range(steps):
        batch = {"tokens": stream.batch(s)["tokens"]}
        if side is not None:
            batch[side[0]] = (0.02 * np.random.default_rng(
                SEQ_CUT_SIDE_SEED + s).standard_normal(
                    (TRAIN_BATCH, side[1], cfg.d_model))).astype(np.float32)
        out.append(batch)
    return out


def _train_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` training steps: two a forward's
    flash and SSD launch (the forward, and remat's recompute in the
    backward; ``_path_launches``), nothing else."""
    flash, ssd, _ = _path_launches(cfg)
    return {k: 2 * n * steps for k, n in (("flash_attention", flash),
                                          ("ssm_chunk_scan", ssd)) if n}


def _train_seq(cfg) -> int:
    """A training batch's positions: TRAIN_SEQ text tokens after
    qwen2-vl's patches (what the dry-run's ShapeSpec counts, and what
    whisper's learned decoder positions are sized for)."""
    return _patches(cfg) + TRAIN_SEQ


def _host_slices(cfg, tree, mesh, preset: str) -> dict:
    """This rank's slices of ``tree`` under ``preset``'s training map
    (``sharding.shard_params``), each copied to the host."""
    from repro_torch.launch import sharding as SH
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to("cpu", copy=True), SH.shard_params(
        cfg, tree, mesh, SH.train_map(preset)))


def _train_build(mesh, arch: str, layers: int, device: str,
                 presets: list, steps: int) -> dict:
    """The bf16 params of ``arch`` at ``layers`` for all its runs, built
    once: rank by rank, the others waiting at a barrier, the full seeded
    params, rank 0's one-rank run of ``steps`` steps on them
    first (each step's fp32 loss of its params beside it: bf16's own
    error), then this rank's slices under each of ``presets`` kept on
    the host, the full copy freed before the next rank builds (the card
    holds one at a time).  Returns {"slices": {preset: slices},
    "one_rank": rank 0's rows (None elsewhere), "build_s"}."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.tree import tree_map
    cfg = _shard_train_cfg(arch, layers)
    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    opt = _train_opt()
    batches = _train_batches(cfg, steps)

    def one_rank(full):
        step = make_train_step(cfg, opt)
        p, st, rows = full, optim.adamw_init(full, opt), []
        for batch in batches:
            with torch.no_grad(), _no_tf32():
                fp32 = T.loss_fn(tree_map(lambda t: t.float(), p), cfg32,
                                 {k: torch.as_tensor(v, device=device)
                                  for k, v in batch.items()})[1]["loss"]
                fp32 = float(fp32)
            p, st, (row,) = _train_steps(step, p, st, [batch], device)
            rows.append(dict(row, fp32_loss=fp32))
        return rows
    t0 = time.perf_counter()
    slices, base = {}, None
    for r in range(mesh.size):
        if r == mesh.rank:
            full = T.init_params(cfg, seed=0, device=device,
                                 max_seq=_train_seq(cfg))
            if r == 0:
                base = one_rank(full)
            slices = {pr: _host_slices(cfg, full, mesh, pr)
                      for pr in presets}
            del full
            _free_quiet(device)
        mesh.barrier()
    return dict(slices=slices, one_rank=base,
                build_s=time.perf_counter() - t0)


def _shard_train_bf16(mesh, arch: str, layers: int, device: str,
                      preset: str, steps: int, built: dict) -> dict:
    """``steps`` bf16 steps on the mesh under ``preset``, from this
    rank's slices in ``built`` (``_train_build``; under baseline with
    rank 0's one-rank run, which the arch's other presets are held to):
    the step's launches, the slices' measured and predicted bytes, peak
    memory."""
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_train_step
    from repro_torch.training import optim
    from repro_torch.tree import tree_map
    cfg = _shard_train_cfg(arch, layers)
    lmap = SH.train_map(preset)
    opt = _train_opt()
    batches = _train_batches(cfg, steps)
    t0 = time.perf_counter()
    local = tree_map(lambda t: t.to(device), built["slices"].pop(preset))
    state = optim.adamw_init(local, opt)
    step = make_train_step(cfg, opt, mesh=mesh, logical_map=lmap)
    build_s = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mesh.barrier()
    ops.reset_launches()
    local, state, rows = _train_steps(step, local, state, batches, device,
                                      mesh, lmap)
    counts = ops.launch_counts()
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, rank=mesh.rank,
               preset=preset, coord=dict(mesh.coord),
               build_s=build_s + (built["build_s"] if preset == "baseline"
                                  else 0.0),
               steps=rows, launches=counts,
               want=_train_launches(cfg, steps),
               param_bytes=_tree_bytes(local),
               moment_bytes=_tree_bytes(state["mu"])
               + _tree_bytes(state["nu"]),
               rule_param_bytes=_plan_bytes(cfg, mesh, lmap),
               rule_moment_bytes=2 * _plan_bytes(cfg, mesh, lmap, 4),
               one_rank=built["one_rank"] if preset == "baseline" else None)
    if device == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del local, state
    _free_quiet(device)
    return out


@contextlib.contextmanager
def _no_tf32():
    """TF32 off inside (exact fp32 matmuls), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _free_quiet(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _fp32_share(kind: str, path: tuple, got, want, nu, lr: float,
                b2: float, big=None,
                rtol: float = SHARD_TRAIN_MOMENT_RTOL) -> float:
    """The share of its tolerance (SHARD_TRAIN_*) the worst entry of one
    leaf uses, after one fp32 step: ``kind`` params, mu or nu; ``big``:
    the leaf's largest moment where ``want`` is a slice of it (default:
    ``want``'s own); ``rtol``: the moments' (``_moment_rtol``).  Taken
    a piece of SHARE_PIECE entries at a time, so its float64 temporaries
    stay small beside the ranks' trees."""
    unembed = path in (("embed",), ("lm_head",))
    got, want, nu = (t.reshape(-1) for t in (got, want, nu))
    if kind != "params" and big is None:
        big = _abs_max(want)
    atol = SHARD_TRAIN_PARAM_ATOL[1 if unembed else 0]
    share = 0.0
    for i in range(0, got.numel(), SHARE_PIECE):
        w = want[i:i + SHARE_PIECE].double()
        err = (got[i:i + SHARE_PIECE].double() - w).abs()
        if kind == "params":
            firm = (torch.sqrt(nu[i:i + SHARE_PIECE].double() / (1 - b2))
                    >= SHARD_TRAIN_SENSITIVE)
            share = max(share, float(err.max()) / (2 * lr))
            if bool(firm.any()):
                share = max(share, float(err[firm].max()) / atol)
            continue
        tol = rtol * (big + w.abs())
        if unembed:
            tol = tol + (1 if kind == "mu" else 2) * 2.0 ** -8 * big
        share = max(share, float((err / tol.clamp_min(1e-30)).max()))
    return share


# entries of a leaf _fp32_share holds in float64 at once
SHARE_PIECE = 1 << 24


def _abs_max(t) -> float:
    """The largest magnitude in ``t``, with no temporary of its size."""
    lo, hi = torch.aminmax(t)
    return max(-float(lo), float(hi))


def _moment_rtol(cfg) -> float:
    """The fp32 check's moment rtol of a config: the recurrent families'
    (hybrid, ssm) SHARD_TRAIN_HYBRID_MOMENT_RTOL, any other
    SHARD_TRAIN_MOMENT_RTOL."""
    return (SHARD_TRAIN_HYBRID_MOMENT_RTOL if cfg.family in ("hybrid", "ssm")
            else SHARD_TRAIN_MOMENT_RTOL)


def _scale_of(path: tuple) -> tuple:
    """The leaf whose largest moment sets the fp32 check's scale for the
    leaf at ``path``: its own, but a key bias's (rounding noise; see
    SHARD_TRAIN_MOMENT_RTOL), the same layer's query bias."""
    return path[:-1] + ("b_q",) if path[-1] == "b_k" else path


def _leaf(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _nest(path: tuple, t) -> dict:
    """A tree holding ``t`` alone, at ``path``."""
    for k in reversed(path):
        t = {k: t}
    return t


def _fp32_setup(arch: str, layers: int) -> tuple:
    """(config, optimizer, batch) of the fp32 check: ``arch`` at
    ``layers`` in fp32, one warmup step, train_smollm's first batch."""
    cfg = _shard_train_cfg(arch, layers, fp32=True)
    return cfg, _train_opt(warmup=1), _train_batches(cfg, 1)


def _shard_train_fp32(mesh, arch: str, layers: int, device: str,
                      preset: str) -> dict:
    """One fp32 step (TF32 off) at ``layers`` on the mesh under
    ``preset`` against a one-rank step on the same params and batch:
    every updated param and both moments, entry by entry, as shares of
    their tolerances; the dropped routings.  The mesh's step runs first;
    then each rank in turn, the others waiting at a barrier (the card
    holds one one-rank step at a time), runs the one-rank step and holds
    its slices of the mesh's result, on the card, to its own slices of
    that step's (``sharding.shard_params``' cut; each moment leaf's
    tolerance from the whole leaf's largest entry), so nothing crosses
    the host.  A leaf's share is the MAX of its slices' over the ranks:
    the whole leaf's."""
    import torch.distributed as dist
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.tree import tree_leaves_with_path
    t0 = time.perf_counter()
    with _no_tf32():
        cfg, opt, batch = _fp32_setup(arch, layers)
        lmap = SH.train_map(preset)
        # every rank builds the full params at once: at these depths 4
        # copies fit
        full = T.init_params(cfg, seed=0, device=device,
                             max_seq=_train_seq(cfg))
        local = SH.shard_params(cfg, full, mesh, lmap)
        del full
        _free_quiet(device)
        local, state, rows = _train_steps(
            make_train_step(cfg, opt, mesh=mesh, logical_map=lmap), local,
            optim.adamw_init(local, opt), batch, device, mesh, lmap)
        times = dict(mesh_step=time.perf_counter() - t0)
        mine = dict(params=local, mu=state["mu"], nu=state["nu"])
        paths = [path for path, _ in tree_leaves_with_path(local)]
        kinds = ("params", "mu", "nu")
        got = torch.zeros((len(kinds), len(paths)), dtype=torch.float64)
        base_rows = None
        # every rank's cached blocks back to the card before the turns
        _free_quiet(device)
        mesh.barrier()
        for r in range(mesh.size):
            if r == mesh.rank:
                full = T.init_params(cfg, seed=0, device=device,
                                     max_seq=_train_seq(cfg))
                p, st, base_rows = _train_steps(
                    make_train_step(cfg, opt), full,
                    optim.adamw_init(full, opt), batch, device)
                del full
                whole = dict(params=p, mu=st["mu"], nu=st["nu"])
                del p, st
                for i, path in enumerate(paths):
                    # this rank's slices of the leaf, one leaf at a time
                    want = {k: _leaf(SH.shard_params(
                        cfg, _nest(path, _leaf(t, path)), mesh, lmap), path)
                        for k, t in whole.items()}
                    for k, kind in enumerate(kinds):
                        got[k, i] = _fp32_share(
                            kind, path, _leaf(mine[kind], path), want[kind],
                            want["nu"], opt.lr, opt.b2,
                            big=None if kind == "params"
                            else _abs_max(_leaf(whole[kind], _scale_of(
                                path))), rtol=_moment_rtol(cfg))
                    del want
                del whole
                _free_quiet(device)
            mesh.barrier()
        times["one_rank"] = time.perf_counter() - t0
        dist.all_reduce(got, op=dist.ReduceOp.MAX, group=mesh.group)
        shares = {kind: dict(share=float(got[k].max()),
                             leaf="/".join(paths[int(got[k].argmax())]),
                             worst=[("/".join(paths[i]), float(got[k, i]))
                                    for i in got[k].argsort(
                                        descending=True)[:4].tolist()])
                  for k, kind in enumerate(kinds)}
        times["compared"] = time.perf_counter() - t0
        out = dict(arch=cfg.name, n_layers=cfg.n_layers, rank=mesh.rank,
                   coord=dict(mesh.coord), rows=rows, shares=shares,
                   seconds_since_start=times, one_rank_rows=base_rows)
        del local, state, mine
        _free_quiet(device)
        return out


def _sharded_train_rank(mesh, runs: tuple = SHARD_TRAIN_RUNS,
                        shape: tuple = SHARD_TRAIN_MESH) -> dict:
    """This rank's part of sharded_train (or of the pod run: POD_TRAIN_RUNS
    on POD_TRAIN_MESH), on a ``shape`` mesh of the world (every rank
    builds it): each arch of ``runs`` built once for all its runs
    (``_train_build``), then its runs in order, each a bf16 run and the
    fp32 check."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*shape, device=mesh.device)
    device = mesh.device.type
    out = {"rank": mesh.rank}
    every = runs
    for arch in dict.fromkeys(run[0] for run in every):
        runs = [run for run in every if run[0] == arch]
        t0 = time.perf_counter()
        built = _train_build(mesh, arch, runs[0][1], device,
                             [run[3] for run in runs],
                             max(run[4] for run in runs))
        for _, layers, check, preset, steps in runs:
            tag = _run_tag(arch, preset)
            out[tag] = _shard_train_bf16(mesh, arch, layers, device, preset,
                                         steps, built)
            out[f"{tag}_fp32"] = _shard_train_fp32(mesh, arch, check,
                                                   device, preset)
            out[f"{tag}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
    return out


def _check_sharded_train(ranks: list, device: str, seconds: float,
                         runs: tuple = SHARD_TRAIN_RUNS,
                         shape: tuple = SHARD_TRAIN_MESH,
                         phase: str = "sharded_train") -> dict:
    """sharded_train's checks of its ranks' readings
    (``_sharded_train_rank``, each rank's; ``seconds``: the slowest
    rank's part), or the pod run's (``runs`` POD_TRAIN_RUNS on ``shape``
    POD_TRAIN_MESH, its lines named after ``phase``).  Per run
    (``runs``): every rank's metrics identical; the loss
    finite (and falling over baseline's SHARD_TRAIN_STEPS steps); each
    step's loss within SHARD_TRAIN_LOSS_FACTOR of the one-rank bf16
    run's gap to fp32 (the arch's baseline run's one-rank steps: the
    same params and batches); flash launched exactly layers x steps x 2
    on every rank and nothing else; each rank's measured param and
    moment bytes equal to the rule's; the fp32 step within its
    tolerances, with the one-rank dropped routings; under every preset
    but baseline (which the dryrun phase holds), every rank's every
    step's collectives by axis and kind, count and bytes, all-to-all
    among them, equal to the dry-run's ``CountingMesh`` (and under
    baseline too on another mesh than SHARD_TRAIN_MESH).  Emits a line
    per run and one for the phase; returns the bf16 runs' launches, all
    ranks summed, and under "readings" rank 0's per baseline and ep run
    (collectives a step by axis and kind, param and moment bytes, peak,
    the slowest rank's median step), which the dryrun phase holds its
    prediction to."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    total, readings, yardstick, failed = {}, {}, {}, []
    for arch, layers, _, preset, steps in runs:
        # every run's lines are emitted before a failed check raises
        try:
            tag = _run_tag(arch, preset)
            rows = [r[tag] for r in ranks]
            r0 = rows[0]
            cfg = _shard_train_cfg(arch, layers)
            losses = [s["loss"] for s in r0["steps"]]
            for k in ("loss", "aux_loss", "grad_norm"):
                check(all([s[k] for s in r["steps"]] == [s[k] for s in
                                                          r0["steps"]]
                          for r in rows), f"{phase} {tag}: the ranks' "
                      f"{k} differ")
            check(all(np.isfinite(losses)), f"{phase} {tag}: losses "
                  f"{losses}")
            if preset == "baseline":
                yardstick[arch] = r0["one_rank"]
            if preset == "baseline" and steps == SHARD_TRAIN_STEPS:
                check(losses[-1] < losses[0], f"{phase} {tag}: losses "
                      f"{losses} do not fall")
            one = yardstick[arch][:steps]
            gap = max(abs(b["loss"] - b["fp32_loss"]) for b in one)
            worst = max(abs(a - b["loss"]) for a, b in zip(losses, one))
            check(worst <= SHARD_TRAIN_LOSS_FACTOR * gap,
                  f"{phase} {tag}: bf16 losses {losses} against one "
                  f"rank's {[b['loss'] for b in one]}: {worst} over "
                  f"{SHARD_TRAIN_LOSS_FACTOR} x {gap}")
            for r in rows:
                check(r["param_bytes"] == r["rule_param_bytes"]
                      and r["moment_bytes"] == r["rule_moment_bytes"],
                      f"{phase} {tag} rank {r['rank']}: bytes "
                      f"{r['param_bytes']}, {r['moment_bytes']} against the "
                      f"rule's {r['rule_param_bytes']}, "
                      f"{r['rule_moment_bytes']}")
                for k, v in r["launches"].items():
                    total[k] = total.get(k, 0) + v
            if device == "cuda":
                check(all({k: v for k, v in r["launches"].items() if v}
                          == r["want"] for r in rows), f"{phase} {tag}: "
                      f"launches {[r['launches'] for r in rows]}, want "
                      f"{r0['want']} a rank and nothing else")
            # the ranks holding distinct rows: a data row's first under the
            # presets that cut the batch over "data", every rank under dp,
            # rank 0 alone under infer-tp2 (the batch whole on every rank)
            distinct = [r for r in rows if {
                "dp": True, "infer-tp2": r["rank"] == 0}.get(
                    preset, r["coord"]["model"] == 0)]
            drops = [sum(r["steps"][s]["drops"] for r in distinct)
                     for s in range(steps)]
            step_ms = [max(r["steps"][s]["ms"] for r in rows)
                       for s in range(steps)]
            kinds = r0["steps"][-1]["kinds"]
            predicted = None
            dense_moe = cfg.family in ("dense", "moe")
            main_mesh = tuple(shape) == tuple(SHARD_TRAIN_MESH)
            if preset != "baseline" or not dense_moe or not main_mesh:
                # gloo's path on the ranks' tensors: through the host on the
                # card, native on the cpu (a rehearsal); the hybrid, audio and
                # vlm runs also their launches a step and their bytes
                res = dryrun_one(arch, ShapeSpec("sharded_train", _train_seq(
                    cfg), TRAIN_BATCH, "train"),
                                 mesh=shape, backend="gloo"
                                 if device == "cuda" else "gloo-cpu",
                                 sharding=preset, cfg=cfg, verbose=False)
                predicted = _kinds(res["collectives_by_axis"])
                for r in rows:
                    for s in r["steps"]:
                        check(s["kinds"] == predicted, f"{phase} {tag} "
                              f"rank {r['rank']}: collectives {s['kinds']}, "
                              f"the dry-run's {predicted}")
                if not dense_moe:
                    check(res["kernels"] == _train_launches(cfg, 1)
                          and res["param_bytes"] == r0["param_bytes"]
                          and res["moment_bytes"] == r0["moment_bytes"],
                          f"{phase} {tag}: the dry-run's launches "
                          f"{res['kernels']}, param and moment bytes "
                          f"{res['param_bytes']}, {res['moment_bytes']}; the "
                          f"card's {r0['launches']} over {steps} steps, "
                          f"{r0['param_bytes']}, {r0['moment_bytes']}")
            n_active = cfg.param_count(active_only=True)
            if preset in ("baseline", "ep") and dense_moe and main_mesh:
                readings[tag] = dict(
                    cfg=cfg, arch=arch, preset=preset,
                    collectives_per_step=r0["steps"][-1]["collectives"],
                    kinds_per_step=kinds,
                    param_bytes=r0["param_bytes"],
                    moment_bytes=r0["moment_bytes"],
                    peak_bytes=r0.get("peak_mem_bytes"),
                    median_step_ms=sorted(step_ms)[len(step_ms) // 2],
                    flash_per_step=r0["launches"]["flash_attention"] / steps)
            emit(f"{phase}_{tag}", arch=cfg.name, n_layers=cfg.n_layers,
                 d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
                 vocab=cfg.vocab_size, dtype=cfg.param_dtype,
                 mesh=list(shape), preset=preset,
                 backend="gloo", steps=steps, batch=TRAIN_BATCH,
                 seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                 losses=losses,
                 aux_losses=[s["aux_loss"] for s in r0["steps"]],
                 grad_norms=[s["grad_norm"] for s in r0["steps"]],
                 one_rank_bf16_losses=[b["loss"] for b in one],
                 one_rank_fp32_losses=[b["fp32_loss"] for b in one],
                 loss_gap_to_one_rank=worst, bf16_yardstick=gap,
                 note="one card time-sliced by 4 processes joined by gloo "
                 "through the host: not a data- or tensor-parallel speed",
                 step_ms=step_ms, tokens_per_s=steps * TRAIN_BATCH
                 * TRAIN_SEQ * 1e3 / sum(step_ms),
                 one_rank_step_ms=[b["ms"] for b in one],
                 one_rank_tokens_per_s=steps * TRAIN_BATCH
                 * TRAIN_SEQ * 1e3 / sum(b["ms"] for b in one),
                 flash_launches_per_rank=[r["launches"]["flash_attention"]
                                          for r in rows],
                 want_per_rank=r0["want"],
                 collectives_per_step=r0["steps"][-1]["collectives"],
                 kinds_per_step=kinds, predicted_kinds=predicted,
                 moe_drops_per_step=drops if cfg.moe is not None else None,
                 one_rank_moe_drops=[b["drops"] for b in one]
                 if cfg.moe is not None else None,
                 params_active=n_active,
                 model_flops_per_token=6 * n_active,
                 seconds=[r[f"{tag}_s"] for r in ranks],
                 per_rank=[{k: r.get(k) for k in (
                     "rank", "coord", "build_s", "param_bytes",
                     "rule_param_bytes", "moment_bytes", "rule_moment_bytes",
                     "peak_mem_bytes")} for r in rows])
            f32 = [r[f"{tag}_fp32"] for r in ranks]
            shares = f32[0]["shares"]
            keep = {r["rank"] for r in distinct}
            mesh_drops = sum(r["rows"][0]["drops"] for r in f32
                             if r["rank"] in keep)
            one_drops = f32[0]["one_rank_rows"][0]["drops"]
            emit(f"{phase}_{tag}_fp32", n_layers=f32[0]["n_layers"],
                 preset=preset, tf32=False, loss=f32[0]["rows"][0]["loss"],
                 one_rank_loss=f32[0]["one_rank_rows"][0]["loss"],
                 grad_norm=f32[0]["rows"][0]["grad_norm"],
                 one_rank_grad_norm=f32[0]["one_rank_rows"][0]["grad_norm"],
                 moe_drops=mesh_drops, one_rank_moe_drops=one_drops,
                 seconds_since_start=f32[0]["seconds_since_start"],
                 share_of_tolerance=shares, tol=dict(
                     param_atol=SHARD_TRAIN_PARAM_ATOL,
                     sensitive=SHARD_TRAIN_SENSITIVE,
                     moment_rtol=SHARD_TRAIN_MOMENT_RTOL,
                     moment_rtol_here=_moment_rtol(cfg)),
                 collectives=f32[0]["rows"][0]["collectives"],
                 kinds=f32[0]["rows"][0]["kinds"])
            check(all(v["share"] <= 1.0 for v in shares.values()),
                  f"{phase} {tag} fp32: {shares} of the tolerances")
            check(mesh_drops == one_drops, f"{phase} {tag} fp32: "
                  f"{mesh_drops} dropped routings against one rank's "
                  f"{one_drops}")
        except AssertionError as e:
            failed.append(str(e))
    emit(phase, ranks=SHARD_RANKS, mesh=list(shape),
         backend="gloo", device=device, launches_all_ranks=total,
         seconds=seconds, failed=failed)
    check(not failed, "; ".join(failed))
    return dict(total, readings=readings)


def _predicted(what: str, res: dict, readings: dict, kernel: str,
               want_kernel: float) -> dict:
    """One dry-run prediction (``launch.dryrun.dryrun_one``'s result)
    beside this run's readings of the same step: the kernel's launches
    a step equal (the count is wrong otherwise), the roofline bound at
    most the measured step, the predicted peak at most the measured one
    (a bound above a measurement means a wrong count).  Returns the
    line's fields."""
    from repro_torch.analysis import roofline
    row = roofline.row_for(res)
    got = res["kernels"].get(kernel, 0)
    check(got == want_kernel, f"dryrun {what}: {got} {kernel} launches a "
          f"step predicted, {want_kernel} on the card")
    step_ms = readings.get("median_step_ms",
                           readings.get("decode_step_ms"))
    bound_ms = 1e3 * row.bound_s
    check(bound_ms <= step_ms, f"dryrun {what}: bound {bound_ms} ms over "
          f"the measured step {step_ms} ms")
    out = dict(bound_ms=bound_ms, bound_by=row.dominant,
               compute_ms=1e3 * row.compute_s, memory_ms=1e3 * row.memory_s,
               collective_ms=1e3 * row.collective_s, step_ms=step_ms,
               measured_over_bound=step_ms / bound_ms,
               flops=res["flops_per_device"], bytes=res["bytes_per_device"],
               kernels=res["kernels"], trace_s=res["trace_s"],
               predicted_peak_bytes=res["peak_bytes"],
               predicted_by_stage=res["memory_by_stage"],
               predicted_memory=res["memory"])
    peak = readings.get("peak_bytes")
    if peak is not None:                     # measured on the card only
        check(res["peak_bytes"] <= peak, f"dryrun {what}: predicted peak "
              f"{res['peak_bytes']} over the measured {peak} bytes")
        out.update(measured_peak_bytes=peak,
                   peak_share_predicted=res["peak_bytes"] / peak)
    for k in ("param_bytes", "moment_bytes"):
        if k in readings:
            check(res[k] == readings[k], f"dryrun {what}: {k} "
                  f"{res[k]} predicted, {readings[k]} on the card")
            out[k] = res[k]
    return out


def _dryrun_seq_cut(r: dict) -> dict:
    """The dry-run of seq_cut's granite-20b decode step (rank 0 of its
    (2, 2) mesh under ``baseline``, gloo's path) held to the readings
    ``r``: collectives a step by axis, the rank's cache bytes, decode
    launches a step, bound and peak (``_predicted``)."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    res = dryrun_one("granite-20b", ShapeSpec("seq_cut", r["cache_len"],
                                              r["batch"], "decode"),
                     mesh=SEQ_CUT_MESH, backend="gloo", sharding="baseline",
                     cfg=r["cfg"], verbose=False)
    by_axis = {a: sum(v["count"] for k, v in kinds.items()
                      if k != "link_bytes")
               for a, kinds in res["collectives_by_axis"].items()}
    check(by_axis == r["collectives_per_step"], f"dryrun seq_cut granite: "
          f"collectives a step {by_axis} predicted, "
          f"{r['collectives_per_step']} on the card")
    check(res["cache_bytes"] == r["cache_bytes"], f"dryrun seq_cut granite: "
          f"cache {res['cache_bytes']} bytes predicted, {r['cache_bytes']} "
          "on the card")
    return dict(
        _predicted("seq_cut granite-20b decode", res, r, "decode_attention",
                   r["decode_per_step"]),
        collectives_per_step=by_axis, collectives=res["collectives_by_axis"],
        predicted_cache_bytes=res["cache_bytes"],
        measured_cache_bytes=r["cache_bytes"])


# the dryrun phase's multi-pod step: rank 0 of the reference's (2, 16, 16)
# mesh of axes ("pod", "data", "model"), no reading to hold it to
MULTI_POD_STEP = ("qwen1.5-4b", "decode_32k")


def _dryrun_multi_pod() -> dict:
    """The dry-run's ``--multi-pod`` step (MULTI_POD_STEP under
    ``baseline``, NCCL's path): its counts by set of axes and kind, its
    launches, cache and param bytes and bound.  Its FSDP gathers run
    over ("pod", "data"), a group that crosses nodes: the roofline
    charges it at the network's rate."""
    from repro_torch.analysis import roofline
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.launch.mesh import NETWORK_BYTES_PER_S
    arch, shape = MULTI_POD_STEP
    res = dryrun_one(arch, shape, multi_pod=True, verbose=False)
    kinds = _kinds(res["collectives_by_axis"])
    pod = {a: k for a, k in kinds.items() if "pod" in a.split(",") and k}
    check(res["mesh"] == "2x16x16" and pod and all(
        roofline.link_bandwidth(res["mesh"], a) == NETWORK_BYTES_PER_S
        for a in pod), f"dryrun multi-pod {arch} {shape}: mesh "
          f"{res['mesh']}, collectives over pod {pod}")
    row = roofline.row_for(res)
    return dict(arch=arch, shape=shape, mesh=res["mesh"],
                n_devices=res["n_devices"], kinds_per_step=kinds,
                kernels=res["kernels"], cache_bytes=res["cache_bytes"],
                rule_cache_bytes=res["rule_cache_bytes"],
                param_bytes=res["param_bytes"],
                predicted_peak_bytes=res["peak_bytes"],
                bound_ms=1e3 * row.bound_s, bound_by=row.dominant,
                collective_ms=1e3 * row.collective_s,
                trace_s=res["trace_s"])


def phase_dryrun(train_smollm: dict, sharded_train: dict,
                 fixed_serve: dict, seq_cut: dict, smi: str) -> dict:
    """The dry-run (``launch.dryrun.dryrun_one``: the step built on the
    meta device and counted, no data on the card) of three steps this
    run measured, held to the phases' readings: train_smollm's step
    (one rank, TRAIN_BATCH x TRAIN_SEQ, bf16): flash launches a step,
    param and moment bytes, bound <= the median step, predicted peak <=
    ``max_memory_allocated``; sharded_train's two models on its (2, 2)
    mesh under baseline, and qwen3-moe under ep, gloo's collective path:
    collectives a step by axis and by kind (count and bytes, the
    exchange's all-to-alls among them), rank 0's param and moment bytes,
    flash a step, bound and peak likewise;
    fixed_serve's decode step (its batch and cache; a cache read full):
    decode launches a step, bound <= the mean step; seq_cut's granite-20b
    decode step (rank 0 of its (2, 2) mesh under ``baseline``, gloo's
    path, the cache's positions cut over "model"): decode launches and
    collectives a step by axis, the rank's cache bytes, bound <= the
    median step, predicted peak <= the measured; and one ``--multi-pod``
    step (``_dryrun_multi_pod``), its counts printed.  Each prediction's
    memory stages are printed beside the reading."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    t0 = time.perf_counter()
    out = {}
    r = train_smollm["readings"]
    res = dryrun_one("smollm-360m", ShapeSpec("train_smollm", TRAIN_SEQ,
                                              TRAIN_BATCH, "train"),
                     mesh=(1, 1), cfg=r["cfg"], verbose=False)
    out["train_smollm"] = _predicted("train_smollm", res, r,
                                     "flash_attention", r["flash_per_step"])
    for r in sharded_train["readings"].values():
        what = f"sharded_train {r['arch']} {r['preset']}"
        res = dryrun_one(r["arch"], ShapeSpec("sharded_train", TRAIN_SEQ,
                                              TRAIN_BATCH, "train"),
                         mesh=SHARD_TRAIN_MESH, backend="gloo", cfg=r["cfg"],
                         sharding=r["preset"], verbose=False)
        by_axis = {a: sum(v["count"] for k, v in kinds.items()
                          if k != "link_bytes")
                   for a, kinds in res["collectives_by_axis"].items()}
        check(by_axis == r["collectives_per_step"], f"dryrun {what}: "
              f"collectives a step {by_axis} predicted, "
              f"{r['collectives_per_step']} on the card")
        kinds = _kinds(res["collectives_by_axis"])
        check(kinds == r["kinds_per_step"], f"dryrun {what}: collectives "
              f"by kind {kinds} predicted, {r['kinds_per_step']} on the "
              "card")
        out[what] = dict(
            _predicted(what, res, r, "flash_attention", r["flash_per_step"]),
            collectives_per_step=by_axis, kinds_per_step=kinds,
            collectives=res["collectives_by_axis"])
    r = fixed_serve["readings"]
    res = dryrun_one("smollm-360m", ShapeSpec("fixed_serve", r["cache_len"],
                                              r["batch"], "decode"),
                     mesh=(1, 1), cfg=r["cfg"], verbose=False)
    out["fixed_serve decode"] = dict(
        _predicted("fixed_serve decode", res, r, "decode_attention",
                   r["decode_per_step"]),
        predicted_cache_bytes=res["cache_bytes"],
        measured_cache_bytes=r["kv_cache_bytes"])
    out["seq_cut granite-20b decode"] = _dryrun_seq_cut(seq_cut)
    out["multi_pod"] = _dryrun_multi_pod()
    seconds = time.perf_counter() - t0
    check(seconds <= DRYRUN_LIMIT_S, f"dryrun took {seconds} s of its "
          f"{DRYRUN_LIMIT_S}")
    emit("dryrun", card=smi, steps=out, seconds=seconds,
         note="predictions are counts on the meta device and bounds under "
         "the H100's data-sheet constants; readings are this run's")
    return out


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
def _held_to_plain(held: dict, shapes: dict = None):
    """Inside the block every flash, decode (paged and contiguous) and
    SSD launch is also computed by its plain version on the same inputs:
    the kernels held to their plain versions at the main path's own
    inputs and strides.  Appends to ``held[name]`` for flash and the two
    decode kernels each launch's share of PAGED_TOL (and, given
    ``shapes``, adds to ``shapes[name]`` the launch's (q's shape, the
    second input's shape, whether it returned the lse)), and to
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
        own inputs appended to held[name] (with the lse, the larger of
        the out's share and the lse's share of LSE_TOL)."""
        def call(q, *a, **kw):
            out = kernel(q, *a, **kw)
            want = plain(q, *a, **kw)
            if shapes is not None:
                shapes.setdefault(name, set()).add(
                    (tuple(q.shape), tuple(a[0].shape),
                     isinstance(out, tuple)))
            share = (max(_share_of_tolerance(out[0], want[0],
                                             *PAGED_TOL[q.dtype]),
                         _share_of_tolerance(out[1], want[1], *LSE_TOL))
                     if isinstance(out, tuple) else
                     _share_of_tolerance(out, want, *PAGED_TOL[q.dtype]))
            held.setdefault(name, []).append(share)
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


def _prefill_checks(params, cfg, tokens: np.ndarray, what: str,
                    extra: dict = None) -> dict:
    """Two more prefills of a serve phase's prompts, after its launch
    counts are read.  One under torch.profiler: the device's busy share
    of the prefill's wall time (the rest is the host's) and its largest
    kernels.  One with every flash and SSD launch held to its plain
    version on its own inputs (``_held_to_plain``), checked: flash
    within the smoke's tolerance, the SSD scan within SSD_PATH_FACTOR.
    Returns both for the phase's line (``_check_held`` checks them)."""
    from repro_torch.models import transformer as T
    batch = {"tokens": torch.from_numpy(tokens).to(params["embed"].device),
             **(extra or {})}
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
    counts are read.  With ``profile``: once more under the launch
    counters, for the decode launches a step makes (one per attention
    layer), and the first such launch's inputs; that launch alone
    captured in a CUDA graph (``_graph_nodes``: one kernel node, so no
    merge kernel); then the step under torch.profiler, for
    the device's busy share of its wall time (the rest is the host's)
    and each decode kernel's microseconds.  Then once with every decode
    launch held to its plain version on its own inputs.  ``launches``:
    the decode launches a step makes.

    Launches are counted by the wrappers and the graph, not by the
    profiler: its windows drop records (a whole layer's at the moe
    family's thousands of kernels a step) and, a window of one kernel
    after a serve run, all of them."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    params, cfg, cache, a, kw = steps.captured

    def step():
        return T.decode_step(params, cfg, cache, *a, **kw)

    out = {}
    if profile:
        first = {}
        before = ops.launch_counts()
        with _first_decode_launch(first):
            step()
            sync()
        after = ops.launch_counts()
        nodes = None
        if first:
            kernel, args = first["kernel"], first["args"]
            nodes = _graph_nodes(lambda: kernel(*args),
                                 f"a decode launch of {first['name']}")
        us, wall_us = profile_device(step, reps=5)
        busy = sum(us.values())
        names = [k for k in us if "decode_kernel" in k or "split_kernel" in k
                 or "merge_kernel" in k]
        out["profiled_decode_step"] = dict(
            wall_s=wall_us / 1e6, device_busy_s=busy / 1e6,
            device_busy_share=busy / wall_us,
            decode_kernels_us={k: us[k] for k in names},
            decode_launches=sum(after[k] - before[k] for k in DECODE_KERNELS),
            want_launches=launches, graph_nodes_a_launch=nodes,
            top_kernels_us=dict(sorted(us.items(), key=lambda kv: -kv[1])[:6]))
    held = {}
    with _held_to_plain(held):
        step()
        sync()
    out["held_to_plain"] = _shares(held)
    return out


@contextlib.contextmanager
def _first_decode_launch(first: dict):
    """Inside the block the first paged or contiguous decode launch
    records, in ``first``, its kernel's name, the kernel and its
    inputs."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import paged_decode_attention as KP
    paged = KP.paged_decode_attention_kernel
    decode = KD.decode_attention_kernel

    def capturing(name, kernel):
        def call(*args, **kw):
            if not first:              # as the wrapper reads them
                q, *rest = (t.contiguous() if torch.is_tensor(t) else t
                            for t in args)
                q = q.clone() if q.data_ptr() % 16 else q
                if name == "decode_attention":   # kv_len an int or (1,)
                    kv, B = rest[2], q.shape[0]
                    rest[2] = (torch.full((B,), kv, dtype=torch.int32,
                                          device=q.device)
                               if isinstance(kv, int)
                               else kv.reshape(-1).expand(B).contiguous())
                first.update(name=name, kernel=kernel, args=(q, *rest))
            return kernel(*args, **kw)
        return call

    KP.paged_decode_attention_kernel = capturing(
        "paged_decode_attention", paged)
    KD.decode_attention_kernel = capturing("decode_attention", decode)
    try:
        yield
    finally:
        KP.paged_decode_attention_kernel = paged
        KD.decode_attention_kernel = decode


def _check_held(out: dict, what: str) -> None:
    """Every launch that ``_prefill_checks`` or ``_decode_checks`` held
    to its plain version within its bound (max_share at most 1); a
    profiled decode step launched one decode kernel per attention layer
    (by the wrappers' counters; each launch one kernel on the device,
    ``_graph_nodes``) and no merge kernel."""
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
    new_paths = dict(shared_prefix_launches=phase_shared_prefix(),
                     speculative_launches=phase_speculative(),
                     constellation_launches=phase_constellation())
    _free("the earlier phases")
    family = dict(moe_serve=phase_moe_serve(), mla_serve=phase_mla_serve(),
                  dense_configs_serve=phase_dense_configs_serve(),
                  xlstm_serve=phase_xlstm_serve())
    phase_train_step()
    training = dict(train_smollm=phase_train_smollm(),
                    lm_cascade=phase_lm_cascade())
    _free("the training phases")
    family["train_families"] = phase_train_families()
    family.update(phase_side_serve())
    phase_audio_vlm_invariants()
    family["train_audio_vlm"] = phase_train_audio_vlm()
    (family["sharded_serve"], seq_cut, family["sharded_train"],
     family["pod_train"]) = phase_mesh()
    phase_dryrun(training["train_smollm"], family["sharded_train"],
                 fixed_counts, seq_cut, dev["smi"])
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
        if name == "paged_decode_attention":
            kernels[-1].update(new_paths)
        for path, fam_counts in family.items():
            kernels[-1][f"{path}_launches"] = fam_counts[name]
        if name == "flash_attention":
            kernels[-1].update(
                ms_lse=row["ms_lse"], plain_backward_ms=row["plain_backward_ms"],
                library_backward_ms=row.get("library_backward_ms"),
                **{f"{p}_launches": c[name] for p, c in training.items()})
        if name == "confidence_gate":
            kernels[-1]["lm_cascade_launches"] = training["lm_cascade"][name]
        kernels[-1]["cases"] = [
            {k: r.get(k) for k in CASE_KEYS} for r in ROWS.get(name, [])
            if r["shape"] in FAMILY_SHAPES.get(name, []) and "ms" in r]
    emit("done", seconds=time.perf_counter() - t0)
    print(dev["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
