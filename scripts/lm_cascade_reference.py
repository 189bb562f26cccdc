"""The JAX package's LM cascade figures, as ``tests/test_lm_cascade.py``
computes them: the tiansuan pair trained on the CPU (ONBOARD 30 steps,
GROUND 90, seq 96, batch 8, lr 2e-3, warmup 5, ``TokenStream`` seed 0),
the gate calibrated to a 0.6 budget on the held-out batch 10,000, then
the collaborative and onboard-only cascades.  Prints one JSON object:
the reference column that ``chip_smoke.py``'s lm_cascade phase prints
beside the port's figures on the card (its ``LM_CASCADE_REFERENCE``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/lm_cascade_reference.py
"""
from __future__ import annotations

import json
import time

import jax.numpy as jnp
import numpy as np

from repro.configs import tiansuan_pair as TP
from repro.core.cascade import CascadeConfig, CollaborativeEngine
from repro.core.gating import ConfidenceGate, calibrate_threshold
from repro.data.tokens import TokenStream, TokenStreamConfig
from repro.models import transformer as T
from repro.training import optim
from repro.training.loop import init_state, train


def main() -> dict:
    t0 = time.time()
    stream = TokenStream(TokenStreamConfig(vocab_size=TP.ONBOARD.vocab_size,
                                           seq_len=96, batch_size=8))
    tiers = {}
    for name, cfg, steps in (("onboard", TP.ONBOARD, 30),
                             ("ground", TP.GROUND, 90)):
        opt = optim.OptimConfig(lr=2e-3, warmup_steps=5, total_steps=steps)
        st = init_state(cfg, opt, max_seq=96)
        st = train(cfg, st, iter(stream), opt, steps=steps, log_every=steps)
        tiers[name] = (cfg, st.params, st.history)

    eval_batch = stream.batch(10_000)["tokens"]
    prefix, target = eval_batch[:, :-1], eval_batch[:, -1]

    def tier_fn(cfg, params):
        def fn(toks):
            logits, _ = T.forward(params, cfg, {"tokens": jnp.asarray(toks)},
                                  remat=False)
            return np.asarray(logits[:, -1], np.float32)
        return fn

    onboard_fn = tier_fn(*tiers["onboard"][:2])
    ground_fn = tier_fn(*tiers["ground"][:2])
    conf = np.asarray(ConfidenceGate("max_prob", 1.1).decide(
        jnp.asarray(onboard_fn(prefix)))["confidence"])
    thr = calibrate_threshold(conf, np.ones_like(conf, bool), 0.6)
    eng = CollaborativeEngine(onboard_fn, ground_fn, CascadeConfig(
        gate=ConfidenceGate("max_prob", thr), item_dtype_bytes=4))
    collab = eng.run(prefix, item_shape=prefix.shape[1:])
    onboard_only = eng.run(prefix, item_shape=prefix.shape[1:],
                           ground_available=False)
    s = collab.ledger.summary()
    out = {
        "onboard_losses": [r["loss"] for r in tiers["onboard"][2]],
        "ground_losses": [r["loss"] for r in tiers["ground"][2]],
        "threshold": thr,
        "acc_collaborative": float(np.mean(collab.predictions == target)),
        "acc_onboard_only": float(np.mean(onboard_only.predictions
                                          == target)),
        "escalated": int(collab.escalated.sum()),
        "escalation_rate": s["escalation_rate"],
        "bytes_downlinked": s["bytes_downlinked"],
        "bytes_bentpipe_baseline": s["bytes_bentpipe_baseline"],
        "seconds": time.time() - t0,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
