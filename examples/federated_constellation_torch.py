"""Federated learning across a mini constellation (paper §3.4) on the
PyTorch port: the twin of examples/federated_constellation.py through
``repro_torch`` only, on the card by default (``--device cpu`` runs the
plain PyTorch path).

Three satellites hold disjoint data shards (privacy: raw data never
downlinked); each trains locally and uploads weights at its next ground
contact; the cloud aggregates with staleness-discounted FedAvg.

    PYTHONPATH=src python examples/federated_constellation_torch.py \
        [--device cpu] [--rounds 3] [--local-steps 10]

The sizes default to the reference example's.  ``main(argv)`` returns
what it prints.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.config import get_reduced_config
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import transformer as T
from repro_torch.training.federated import FedConfig, run_federated


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced_config("smollm-360m")
    fed = FedConfig(n_satellites=3, local_steps=args.local_steps,
                    rounds=args.rounds)
    print(f"federating {cfg.name} across {fed.n_satellites} satellites, "
          f"{fed.rounds} rounds x {fed.local_steps} local steps")

    def make_data(i):
        return iter(TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
            seed=1000 + i)))

    out = run_federated(cfg, fed, make_data, device=device)
    for r in out["rounds"]:
        w = ", ".join(f"{x:.2f}" for x in r["weights"])
        l = ", ".join(f"{x:.3f}" for x in r["local_losses"])  # noqa: E741
        print(f"  round {r['round']}: staleness weights [{w}] "
              f"local losses [{l}]")

    # evaluate the aggregated global model on held-out data
    held_out = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=8, seed=77))
    batch = {"tokens": torch.as_tensor(held_out.batch(0)["tokens"],
                                       device=device)}
    with torch.no_grad():
        loss, _ = T.loss_fn(out["global_params"], cfg, batch)
    print(f"global model held-out loss: {float(loss):.3f}")
    return {"rounds": out["rounds"], "held_out_loss": float(loss)}


if __name__ == "__main__":
    main()
