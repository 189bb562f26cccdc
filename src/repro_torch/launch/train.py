"""Training launcher of the port: the twin of the single-host part of
the JAX package's ``launch/train.py``.  It runs real steps of any
config (whisper-tiny and qwen2-vl-2b with the reference's side inputs,
``0.01 * ones`` frames or patch embeddings, added to every batch) on the
``TokenStream`` (seed 0) and prints one JSON row per
logged step; with ``--checkpoint`` it writes the trained params in the
``.ckpt`` layout of ``checkpoint/store``.  Runs on the GPU
(``--device cuda``, the default) and raises without one; ``--device
cpu`` runs the plain PyTorch path.

With ``--ranks N --mesh DxM`` it trains on a ``(D, M)`` mesh of N = D x M
ranks (``--mesh PxDxM``: a ``(P, D, M)`` mesh of axes ("pod", "data",
"model"), the batch and FSDP over ("pod", "data") under ``baseline``;
``launch.mesh.spawn``, one process a rank, joined by ``--backend``
gloo or nccl) under the reference's ``--sharding`` preset (also ``--preset``; ``baseline``: tensor parallel over "model", FSDP and
the batch over "data"; ``dp``: the batch over both axes, FSDP over
"data", experts over "model"; ``ep``: ``baseline`` with the experts
over both axes; ``infer-tp``: ``baseline`` without FSDP;
``infer-tp2``: tensor parallel over both axes, the batch whole; where
the experts and the batch share an axis the MoE exchanges tokens with
the experts' owners; every family: dense, moe, hybrid with its Mamba2
blocks cut on whole heads, ssm with its xLSTM blocks cut on whole
heads, audio and vlm with their side inputs cut on their rows).  Every
rank draws the same batches and keeps its rows; rank 0 prints the rows, which are the whole batch's.
``--checkpoint`` then writes the UNSHARDED params (the ranks' slices
gathered exactly), so the checkpoint loads into a one-rank engine and
into the reference's ``load_checkpoint``.  Under gloo every rank runs
on the current card (or the CPU), under NCCL rank r on ``cuda:r``.

``--dry-run`` builds the FULL config's train step at ``--shape``
(default ``train_4k``) as rank 0 of the ``--mesh`` (default the
reference's production 16x16) sees it, on the meta device, and prints
its counted work (``launch.dryrun.dryrun_one``, under ``--sharding`` and
``--backend``'s collective path, default nccl; ``--reduced`` counts the
reduced config instead); it needs no card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --batch 8 --seq 256 [--reduced] [--lr 1e-3] \\
        [--checkpoint out.ckpt] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --reduced --steps 20 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \
        --reduced --steps 20 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --reduced --steps 20 --batch 4 --seq 64 --device cpu  # qwen2-vl-2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --reduced --steps 20 --batch 8 --seq 64 --device cpu \
        --ranks 4 --mesh 2x2 [--sharding dp] [--checkpoint out.ckpt]
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen3-moe-30b-a3b --ranks 4 --mesh 2x2 --sharding ep
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --reduced --steps 2 --batch 4 --seq 64 --device cpu --ranks 4 \
        --mesh 2x2 --sharding infer-tp2      # also whisper-tiny, qwen2-vl-2b
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --dry-run [--shape train_4k] [--mesh 16x16 | 2x16x16] [--sharding ep]
"""
from __future__ import annotations

import argparse
import json
import os


def with_side_inputs(cfg, batches, batch: int):
    """``batches`` with the reference launcher's side inputs added to
    each (``0.01 * ones`` in bf16, as there): audio frames (batch,
    n_audio_frames, d) for whisper, patch embeddings (batch, n_patches,
    d) for qwen2-vl."""
    import torch
    from repro_torch.config import side_input
    side = side_input(cfg)
    for b in batches:
        if side is not None:
            b[side[0]] = torch.full((batch, side[1], cfg.d_model), 0.01,
                                    dtype=torch.bfloat16)
        yield b


def _run(mesh, args):
    """One rank's (or the one process's) training run; returns its
    state.  ``mesh`` None: one rank."""
    from repro_torch import resolve_device
    from repro_torch.config import get_config, get_reduced_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.launch import sharding as SH
    from repro_torch.training import optim
    from repro_torch.training.loop import init_state, train

    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    opt_cfg = optim.OptimConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch))
    lmap = None
    if mesh is None:
        device = resolve_device(args.device)
    else:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(*args.mesh, device=mesh.device)
        device = mesh.device
        lmap = SH.check_train(cfg, SH.train_map(args.preset))
    printing = mesh is None or mesh.rank == 0

    def log(row):
        if printing:
            print(json.dumps(row))
    state = init_state(cfg, opt_cfg, max_seq=args.seq, device=device,
                       mesh=mesh, logical_map=lmap)
    state = train(cfg, state, with_side_inputs(cfg, iter(stream),
                                               args.batch),
                  opt_cfg, steps=args.steps, log_every=10, callback=log,
                  mesh=mesh, logical_map=lmap)
    if args.checkpoint:
        from repro_torch.checkpoint import save_checkpoint
        params = state.params
        if mesh is not None:
            params = SH.unshard_params(cfg, params, mesh, lmap)
        if printing:
            n = save_checkpoint(args.checkpoint, params,
                                {"arch": cfg.name, "step": state.step})
            print(f"checkpoint: {args.checkpoint} ({n/1e6:.1f} MB)")
        if mesh is not None:
            mesh.barrier()
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--mesh", default=None,
                    help="DxM (data x model) or PxDxM (pod x data x model) "
                    "ranks (default 1xRANKS)")
    ap.add_argument("--sharding", "--preset", dest="preset",
                    default="baseline", choices=("baseline", "dp", "ep",
                                                 "infer-tp", "infer-tp2"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: gloo (a dry-run: nccl)")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.config import get_reduced_config
        from repro_torch.launch.dryrun import dryrun_one, parse_mesh
        return dryrun_one(args.arch, args.shape, sharding=args.preset,
                          mesh=parse_mesh(args.mesh or "16x16"),
                          backend=args.backend or "nccl",
                          cfg=get_reduced_config(args.arch)
                          if args.reduced else None)
    args.backend = args.backend or "gloo"
    if args.ranks == 1 and args.mesh is None:
        return _run(None, args)
    import math
    from repro_torch.launch.dryrun import parse_mesh
    from repro_torch.launch.mesh import spawn
    text = args.mesh or f"1x{args.ranks}"
    args.mesh = parse_mesh(text)
    if math.prod(args.mesh) != args.ranks:
        raise ValueError(f"--mesh {text} is not {args.ranks} ranks")
    # CPU ranks share the host's cores instead of each taking all of them
    threads = (max(1, (os.cpu_count() or 1) // args.ranks)
               if args.device == "cpu" else None)
    spawn(_run_rank, args.ranks, args, backend=args.backend,
          device=args.device, threads=threads)


def _run_rank(mesh, args):
    _run(mesh, args)        # the states stay in the ranks


if __name__ == "__main__":
    main()
