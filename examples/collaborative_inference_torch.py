"""END-TO-END DRIVER on the PyTorch port: the paper's case study as a
running system, the twin of examples/collaborative_inference.py through
``repro_torch`` only, on the card by default (``--device cpu`` runs the
plain PyTorch path).

A Tiansuan-style deployment: the cloud-native control plane registers a
satellite (Baoyun) and a ground station, deploys the onboard/ground
tiers via manifests, then serves batched EO requests through the full
collaborative pipeline:

    frames -> onboard tile split -> cloud/redundancy filter
           -> onboard tier inference -> confidence gate (the conf_gate
              kernel on the card) -> {results downlink | raw escalation
              over the contact-gated message bus} -> ground tier
           -> merged predictions

and prints the paper's headline metrics from the ledger (accuracy vs
in-orbit-only, downlinked bytes vs bent-pipe, energy shares).

    PYTHONPATH=src python examples/collaborative_inference_torch.py \
        [--device cpu] [--train-tiles 2000] [--onboard-steps 500] \
        [--ground-steps 700] [--frames 800]

The sizes default to the reference example's.  ``main(argv)`` returns
what it prints.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import classifier as CL
from repro_torch.core.cascade import CascadeConfig, CollaborativeEngine
from repro_torch.core.energy import EnergyModel
from repro_torch.core.filtering import filter_tiles
from repro_torch.core.gating import ConfidenceGate, calibrate_threshold
from repro_torch.core.link import ContactSchedule
from repro_torch.core.tiling import split_batch
from repro_torch.data import eo
from repro_torch.orchestration import (AppManifest, Deployer, MessageBus,
                                       NodeSpec, Registry)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-tiles", type=int, default=2000)
    ap.add_argument("--onboard-steps", type=int, default=500)
    ap.add_argument("--ground-steps", type=int, default=700)
    ap.add_argument("--frames", type=int, default=800)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- control plane ----------------------------------------------------
    print("[1/5] registering nodes (KubeEdge-style control plane)")
    reg = Registry()
    reg.register(NodeSpec("baoyun", "satellite",
                          contacts=ContactSchedule(seed=4)))
    reg.register(NodeSpec("ground-0", "ground"))
    bus = MessageBus(reg)

    print("[2/5] training tier models (YOLOv3-tiny / YOLOv3 analogues)")
    # match the captured scene's clear-tile distribution (V1 defaults)
    tcfg = eo.EOConfig(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.55,
                       noise=0.24, seed=41)
    tr_t, tr_l, _ = eo.make_tiles(args.train_tiles, tcfg)
    onboard_p, _ = CL.train_classifier(CL.ONBOARD, tr_t, tr_l,
                                       steps=args.onboard_steps,
                                       device=device)
    ground_p, _ = CL.train_classifier(CL.GROUND, tr_t, tr_l,
                                      steps=args.ground_steps, device=device)

    dep = Deployer(reg)
    dep.apply(AppManifest("onboard-infer", "baoyun",
                          factory=lambda: (CL.ONBOARD, onboard_p)))
    dep.apply(AppManifest("ground-infer", "ground-0",
                          factory=lambda: (CL.GROUND, ground_p)))

    # ---- a day in orbit: frames arrive in batches ---------------------------
    print("[3/5] capturing frames, splitting, filtering onboard")
    scene = eo.EOConfig(cloud_fraction=0.86, dup_fraction=0.30,
                        contrast=0.55, noise=0.24, seed=1)   # cloudy scene
    frames, labels, _ = eo.make_tiles(args.frames, scene)
    on_card = torch.as_tensor(frames, device=device)
    tiles = split_batch(on_card, 32)
    del tiles   # labels carry over 1:1: the frames are already tile-sized
    keep, fstats = filter_tiles(on_card)
    keep = keep.cpu().numpy()
    survivors, slabels = frames[keep], labels[keep]
    filter_rate = float(fstats["filter_rate"])
    print(f"    filter rate: {filter_rate:.2f} "
          f"({len(survivors)}/{len(frames)} tiles survive)")

    # ---- collaborative inference -------------------------------------------
    print("[4/5] onboard inference + confidence gate + escalation")
    cfgs, onboard_params = dep.worker("onboard-infer")
    gcfg, ground_params = dep.worker("ground-infer")

    def onboard_fn(b):
        return CL.apply_classifier(onboard_params, cfgs, b)
    probe = ConfidenceGate("max_prob", 1.1).decide(
        onboard_fn(survivors))["confidence"].cpu().numpy()
    thr = calibrate_threshold(probe, np.ones_like(probe, bool), 0.45)
    engine = CollaborativeEngine(
        onboard_fn, lambda b: CL.apply_classifier(ground_params, gcfg, b),
        CascadeConfig(gate=ConfidenceGate("max_prob", thr),
                      item_dtype_bytes=4), device=device)
    res = engine.run(survivors, item_shape=survivors.shape[1:])
    inorbit = engine.run(survivors, item_shape=survivors.shape[1:],
                         ground_available=False)

    # escalated payloads ride the contact-gated bus
    n_esc = int(res.escalated.sum())
    dt = bus.send("baoyun", "ground-0", "escalations", None,
                  nbytes=int(res.ledger.get("bytes_raw_escalated")), t=0.0)
    bus.advance(dt or 0.0)

    # ---- report -------------------------------------------------------------
    print("[5/5] results")
    valid = slabels >= 0
    acc_c = float(np.mean(res.predictions[valid] == slabels[valid]))
    acc_o = float(np.mean(inorbit.predictions[valid] == slabels[valid]))
    s = res.ledger.summary()
    em = EnergyModel()
    print(f"    in-orbit accuracy:        {acc_o:.3f} "
          f"({int(valid.sum())} labeled survivors)")
    print(f"    collaborative accuracy:   {acc_c:.3f} "
          f"(+{(acc_c-acc_o)/max(acc_o,1e-9)*100:.0f}% relative; paper "
          f"reports ~+50% — see benchmarks/fig7 for the calibrated run)")
    print(f"    escalated:                {n_esc}/{len(survivors)} items, "
          f"delivered at t={dt:.0f}s via contact window")
    print(f"    downlinked bytes:         {int(s['bytes_downlinked']):,} vs "
          f"bent-pipe {int(frames.nbytes):,}")
    reduction = 1 - s['bytes_downlinked'] / frames.nbytes
    print(f"    total data reduction:     {reduction:.2f} (paper: 0.90)")
    print(f"    compute share of energy:  "
          f"{em.compute_share_of_total():.2f} (paper: 0.17)")
    return {"filter_rate": filter_rate, "survivors": len(survivors),
            "frames": len(frames), "labeled": int(valid.sum()),
            "inorbit_accuracy": acc_o, "collaborative_accuracy": acc_c,
            "escalated": n_esc, "delivered_t": dt,
            "bytes_downlinked": int(s["bytes_downlinked"]),
            "bytes_bentpipe": int(frames.nbytes),
            "data_reduction": reduction,
            "compute_share": em.compute_share_of_total()}


if __name__ == "__main__":
    main()
