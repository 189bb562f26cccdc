"""Quickstart on the PyTorch port: train a reduced assigned architecture
on the synthetic token stream, checkpoint it, reload, and generate.  The
twin of examples/quickstart.py through ``repro_torch`` only, on the card
by default (``--device cpu`` runs the plain PyTorch path).

    PYTHONPATH=src python examples/quickstart_torch.py [--arch xlstm-1.3b] \
        [--steps 40] [--device cpu] [--checkpoint model.ckpt]

``main(argv)`` returns what it prints: the logged losses, the checkpoint's
bytes and path (``--checkpoint`` keeps it; by default it goes to a
temporary directory) and the generated tokens.
"""
import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.config import ARCH_IDS, get_reduced_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import optim
from repro_torch.training.loop import init_state, train
from repro_torch.tree import tree_map

LOG_EVERY = 10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint", default=None,
                    help="where to keep the checkpoint (default: a "
                         "temporary directory, removed after the reload)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config(args.arch)
    print(f"[1/4] training {cfg.name} ({cfg.param_count():,} params)")
    opt_cfg = optim.OptimConfig(lr=2e-3, warmup_steps=5,
                                total_steps=args.steps)
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size,
                                           seq_len=128, batch_size=8))
    state = init_state(cfg, opt_cfg, max_seq=128, device=device)
    losses = []

    def log(row):
        losses.append(row["loss"])
        if row["step"] % LOG_EVERY == 0 or row["step"] == 1:
            print(f"    step {row['step']:3d} loss {row['loss']:.3f}")
    state = train(cfg, state, iter(stream), opt_cfg, steps=args.steps,
                  log_every=1, callback=log)

    with tempfile.TemporaryDirectory() as d:
        path = args.checkpoint or os.path.join(d, "model.ckpt")
        nbytes = save_checkpoint(path, state.params, {"arch": cfg.name})
        print(f"[2/4] checkpointed {nbytes/1e6:.1f} MB -> {path}")
        params, meta = load_checkpoint(path, state.params)
        print(f"[3/4] reloaded checkpoint for {meta['arch']}")

    params = tree_map(lambda t: t.to(device), params)   # loaded on the host
    eng = ServingEngine(cfg, params, max_seq=160)
    prompt = stream.batch(0)["tokens"][:2, :16]
    res = eng.generate(prompt, max_new=12)
    print("[4/4] generated continuations:")
    for row in res.tokens:
        print("   ", row.tolist())
    return {"arch": cfg.name, "losses": losses, "checkpoint_bytes": nbytes,
            "checkpoint": args.checkpoint, "tokens": res.tokens.tolist()}


if __name__ == "__main__":
    main()
