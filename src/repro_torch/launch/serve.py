"""Serving launcher of the port: the twin of the JAX package's
``launch/serve.py``.  By default it generates for one fixed-slot batch
of ``batch`` prompts through ``ServingEngine.generate``; with
``--continuous`` it serves ``2 * batch`` requests through the
``ContinuousEngine`` with ``batch`` slots (the paged layout for a dense
or moe arch, the contiguous one for zamba2-7b and xlstm-1.3b; whisper-tiny
and qwen2-vl-2b are served by the fixed-slot engine only, with the
reference's side inputs, ``0.01 * ones`` frames or patch embeddings).  Either way the confidence
gate decides every result, and each sequence's tokens and escalate flag
are printed.  Runs on the GPU (``--device cuda``, the default) and
raises without one; ``--device cpu`` runs the plain PyTorch path.
``--dry-run`` builds the FULL config's step at ``--shape`` (default
``decode_32k``; a prefill shape builds the prefill step) on the
reference's production 16x16 mesh (or ``--mesh DxM``) under
``--sharding`` (any of the reference's presets), as rank 0 sees it,
on the meta device, and prints its counted work
(``launch.dryrun.dryrun_one``; ``--reduced`` counts the reduced config
instead); it needs no card.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --reduced --batch 3 --prompt-len 12 --max-new 5 --max-seq 64 \
        [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --reduced --device cpu [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --reduced --device cpu [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --reduced --device cpu [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-20b \
        --reduced --device cpu [--continuous]      # also granite-34b,
                                                   # qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --reduced --device cpu [--continuous]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --reduced --device cpu                     # also qwen2-vl-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --dry-run [--shape decode_32k] [--sharding infer-tp2] [--mesh 16x16]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(2 * batch requests, slots = --batch)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--sharding", default="baseline",
                    choices=("baseline", "dp", "ep", "infer-tp",
                             "infer-tp2"), help="a dry-run's preset")
    ap.add_argument("--mesh", default="16x16", help="a dry-run's DxM")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.config import get_reduced_config
        from repro_torch.launch.dryrun import dryrun_one, parse_mesh
        return dryrun_one(args.arch, args.shape, sharding=args.sharding,
                          mesh=parse_mesh(args.mesh),
                          cfg=get_reduced_config(args.arch)
                          if args.reduced else None)

    from repro_torch import resolve_device
    from repro_torch.config import get_config, get_reduced_config, side_input
    from repro_torch.core.gating import ConfidenceGate

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    rng = np.random.default_rng(0)
    gate = ConfidenceGate()
    if args.continuous:
        from repro_torch.serving.batching import Request
        from repro_torch.serving.engine import ContinuousEngine
        eng = ContinuousEngine.init(cfg, device=device, n_slots=args.batch,
                                    max_seq=args.max_seq)
        reqs = [Request(prompt=rng.integers(
                    0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                        max_new=args.max_new, arrival_t=float(i))
                for i in range(2 * args.batch)]
        results = eng.run(reqs)
        print("generated tokens (continuous, finish order "
              f"{eng.finish_order}):")
        for rid in sorted(results):
            res = results[rid]
            dec = gate.decide(torch.from_numpy(res.logits_last[None])
                              .to(device))
            print(f"  rid={rid} escalate={bool(dec['escalate'][0])}",
                  res.tokens.tolist())
        return
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine.init(cfg, max_seq=args.max_seq, device=device)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    side = side_input(cfg)
    extra = None if side is None else {side[0]: 0.01 * np.ones(
        (args.batch, side[1], cfg.d_model), np.float32)}
    res = eng.generate(prompts, max_new=args.max_new, extra_inputs=extra)
    dec = gate.decide(torch.from_numpy(res.logits_last).to(device))
    print("generated tokens:")
    for i, row in enumerate(res.tokens):
        print(f"  escalate={bool(dec['escalate'][i])}", row.tolist())


if __name__ == "__main__":
    main()
