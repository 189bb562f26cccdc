"""Training launcher of the port: the twin of the single-host part of
the JAX package's ``launch/train.py``.  It runs real steps of any
config (whisper-tiny and qwen2-vl-2b with the reference's side inputs,
``0.01 * ones`` frames or patch embeddings, added to every batch) on the
``TokenStream`` (seed 0) and prints one JSON row per
logged step; with ``--checkpoint`` it writes the trained params in the
``.ckpt`` layout of ``checkpoint/store``.  Runs on the GPU
(``--device cuda``, the default) and raises without one; ``--device
cpu`` runs the plain PyTorch path.

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
"""
from __future__ import annotations

import argparse
import json


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
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.config import get_config, get_reduced_config
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.training import optim
    from repro_torch.training.loop import init_state, train

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    opt_cfg = optim.OptimConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch))
    state = init_state(cfg, opt_cfg, max_seq=args.seq, device=device)
    state = train(cfg, state, with_side_inputs(cfg, iter(stream),
                                               args.batch),
                  opt_cfg, steps=args.steps, log_every=10,
                  callback=lambda row: print(json.dumps(row)))
    if args.checkpoint:
        from repro_torch.checkpoint import save_checkpoint
        n = save_checkpoint(args.checkpoint, state.params,
                            {"arch": cfg.name, "step": state.step})
        print(f"checkpoint: {args.checkpoint} ({n/1e6:.1f} MB)")
    return state


if __name__ == "__main__":
    main()
