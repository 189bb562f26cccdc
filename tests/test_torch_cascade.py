"""The port's ``CollaborativeEngine`` against the JAX package's on the
same tiers and inputs, on the CPU: stub tiers (the cases of
tests/test_cascade_edges.py), the tile-classifier tiers on bridged
params over the filtered Figure-6 scene, and the tiansuan LM pair on
bridged params through the port's ``forward``.  Predictions, escalations
and every ledger counter are equal, ``bytes_raw_escalated`` under
``quantize_payload`` included (the port counts it from the int8 rows
and fp32 scales it built); confidences within 1e-6 (fp32 softmax of the
same logits, summed in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiansuan_pair as JTP  # noqa: E402
from repro.core import classifier as JCL  # noqa: E402
from repro.core.cascade import CascadeConfig as JCascadeConfig  # noqa: E402
from repro.core.cascade import CollaborativeEngine as JEngine  # noqa: E402
from repro.core.filtering import filter_tiles as jfilter  # noqa: E402
from repro.core.gating import ConfidenceGate as JGate  # noqa: E402
from repro.core.gating import calibrate_threshold  # noqa: E402
from repro.data import eo as jeo  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bridge import (classifier_params_from_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.configs import tiansuan_pair as TTP  # noqa: E402
from repro_torch.core import classifier as TCL  # noqa: E402
from repro_torch.core.cascade import CascadeConfig  # noqa: E402
from repro_torch.core.cascade import CollaborativeEngine  # noqa: E402
from repro_torch.core.gating import ConfidenceGate  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ITEM_SHAPE = (16, 16, 3)


def _logits(n, v=4, seed=0, sharp=None):
    """Diffuse normal logits; ``sharp``: a mask of rows given one
    dominant class (confident)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, v)).astype(np.float32)
    if sharp is not None:
        x[sharp, rng.integers(0, v, n)[sharp]] += 25.0
    return x


def _pair(onboard_fn, ground_fn, threshold, **kw):
    """The JAX engine and the port's (on the CPU) on the same tiers."""
    j = JEngine(onboard_fn, ground_fn,
                JCascadeConfig(gate=JGate("max_prob", threshold), **kw))
    t = CollaborativeEngine(onboard_fn, ground_fn,
                            CascadeConfig(gate=ConfidenceGate("max_prob",
                                                              threshold),
                                          **kw), device="cpu")
    return j, t


def _same(got, want, conf_atol=1e-6):
    np.testing.assert_array_equal(got.predictions, want.predictions)
    assert got.predictions.dtype == want.predictions.dtype
    np.testing.assert_array_equal(got.escalated, want.escalated)
    np.testing.assert_allclose(got.confidence, want.confidence,
                               atol=conf_atol, rtol=0)
    assert got.ledger.counters == want.ledger.counters
    assert got.ledger.summary() == want.ledger.summary()


def _check_payload(res, batch, item_shape):
    """Under quantize_payload the port built the escalated items' int8
    rows and scales: those of the plain version, of the ledger's size."""
    n_esc = int(res.escalated.sum())
    if not n_esc:
        assert res.payload is None
        return
    q, s = res.payload
    rows = np.asarray(batch)[res.escalated].reshape(n_esc, -1)
    wq, ws = ref.int8_quantize_ref(torch.from_numpy(rows.astype(np.float32)))
    assert q.shape == (n_esc, int(np.prod(item_shape))) and s.shape == (n_esc,)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert res.ledger.get("bytes_raw_escalated") == q.numel() + 4 * s.numel()


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype_bytes", [1, 4])
@pytest.mark.parametrize("ground_available", [True, False])
def test_stub_tiers_match_jax(quantize, dtype_bytes, ground_available):
    """Half the items confident, half diffuse; a ground tier with its own
    sharp answers."""
    n = 12
    rng = np.random.default_rng(dtype_bytes)
    onboard = _logits(n, seed=1, sharp=np.arange(n) % 2 == 0)
    ground = _logits(n, seed=2, sharp=np.ones(n, bool))
    batch = rng.random((n, *ITEM_SHAPE)).astype(np.float32)
    if dtype_bytes == 1:
        batch = (batch * 255).astype(np.uint8)
    onboard_fn = lambda b: onboard[:len(b)]             # noqa: E731
    ground_fn = lambda b: ground[:len(b)]               # noqa: E731
    j, t = _pair(onboard_fn, ground_fn, 0.99, quantize_payload=quantize,
                 item_dtype_bytes=dtype_bytes)
    kw = dict(ground_available=ground_available)
    want, got = j.run(batch, ITEM_SHAPE, **kw), t.run(batch, ITEM_SHAPE, **kw)
    _same(got, want)
    assert int(got.escalated.sum()) == (n // 2 if ground_available else 0)
    if quantize:
        _check_payload(got, batch, ITEM_SHAPE)
    else:
        assert got.payload is None


@pytest.mark.parametrize("quantize", [False, True])
def test_empty_batch_matches_jax(quantize):
    logits = _logits(0)
    j, t = _pair(lambda b: logits, lambda b: pytest.fail("no ground call"),
                 0.99, quantize_payload=quantize)
    batch = np.zeros((0, *ITEM_SHAPE), np.float32)
    ops.reset_launches()
    got, want = t.run(batch, ITEM_SHAPE), j.run(batch, ITEM_SHAPE)
    _same(got, want)
    assert got.predictions.shape == (0,) and got.payload is None
    assert got.ledger.summary()["escalation_rate"] == 0.0
    assert ops.launch_counts()["int8_quantize"] == 0


def test_dict_batch():
    """A dict batch goes to the tiers and the ground subset as in the
    reference; under quantize_payload it is charged the reference's
    int8 bytes (no single raw item to build: no payload, no kernel)."""
    n = 6
    onboard = _logits(n, seed=4, sharp=np.arange(n) < 2)
    ground = _logits(n, seed=5, sharp=np.ones(n, bool))
    batch = {"tokens": np.arange(n * 5, dtype=np.int32).reshape(n, 5),
             "mask": np.ones((n, 5), bool)}
    seen = []

    def ground_fn(b):
        seen.append(b)
        return ground[:len(b["tokens"])]

    j, t = _pair(lambda b: onboard, ground_fn, 0.99, item_dtype_bytes=4)
    want = j.run(batch, (5,))
    got = t.run(batch, (5,))
    _same(got, want)
    np.testing.assert_array_equal(seen[1]["tokens"], seen[0]["tokens"])
    jq, tq = _pair(lambda b: onboard, ground_fn, 0.99, quantize_payload=True,
                   item_dtype_bytes=4)
    ops.reset_launches()
    got, want = tq.run(batch, (5,)), jq.run(batch, (5,))
    _same(got, want)
    assert got.payload is None
    assert ops.launch_counts()["int8_quantize"] == 0
    n_esc = int(want.escalated.sum())
    assert n_esc == n - 2
    assert got.ledger.summary()["bytes_raw_escalated"] == n_esc * (5 + 4)


def test_quantize_payload_item_shape_must_match_the_items():
    """Under quantize_payload each escalated item becomes one int8 row of
    prod(item_shape) elements, so an item_shape that does not match the
    batch's items raises, naming both sizes; the reference uses
    item_shape only for its byte count and runs."""
    n = 4
    batch = np.ones((n,) + ITEM_SHAPE, np.float32)
    onboard = _logits(n, seed=6)
    _, t = _pair(lambda b: onboard, lambda b: onboard[:len(b)], 0.99,
                 quantize_payload=True)
    with pytest.raises(ValueError, match="768 elements.*says 192"):
        t.run(batch, (8, 8, 3))
    got = t.run(batch, ITEM_SHAPE)
    assert got.payload[0].shape == (int(got.escalated.sum()), 768)


@pytest.fixture(scope="module")
def eo_tiers():
    """The tile-classifier pair trained briefly in JAX (the data
    reduction benchmark's training regime), bridged into the port."""
    tcfg = jeo.EOConfig(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.9,
                        noise=0.22, seed=31)
    tr_t, tr_l, _ = jeo.make_tiles(300, tcfg)
    out = {}
    for name, jcfg, tcfg_ in (("onboard", JCL.ONBOARD, TCL.ONBOARD),
                              ("ground", JCL.GROUND, TCL.GROUND)):
        jp, _ = JCL.train_classifier(jcfg, tr_t, tr_l, steps=40)
        out[name] = (jcfg, tcfg_, jp, classifier_params_from_numpy(
            jax.device_get(jp), tcfg_, device="cpu"))
    return out


@pytest.mark.parametrize("quantize", [False, True])
def test_classifier_tiers_on_the_filtered_scene_match_jax(eo_tiers,
                                                          quantize):
    """data_reduction's pipeline at 500 V1 tiles: filter, calibrate the
    gate to a 35 % budget on the survivors, run the cascade."""
    tiles, _, _ = jeo.make_tiles(500, jeo.V1)
    keep = np.asarray(jfilter(jnp.asarray(tiles))[0])
    surv = tiles[keep]
    (jo, to, jpo, tpo), (jg, tg, jpg, tpg) = (eo_tiers["onboard"],
                                              eo_tiers["ground"])
    j_on = lambda b: JCL.apply_classifier(jpo, jo, jnp.asarray(b))  # noqa
    j_gr = lambda b: JCL.apply_classifier(jpg, jg, jnp.asarray(b))  # noqa
    probe = np.asarray(JGate("max_prob", 1.1).decide(j_on(surv))
                       ["confidence"])
    thr = calibrate_threshold(probe, np.ones_like(probe, bool), 0.35)
    kw = dict(quantize_payload=quantize, item_dtype_bytes=4)
    j = JEngine(j_on, j_gr, JCascadeConfig(gate=JGate("max_prob", thr), **kw))
    t = CollaborativeEngine(
        lambda b: TCL.apply_classifier(tpo, to, b),
        lambda b: TCL.apply_classifier(tpg, tg, b),
        CascadeConfig(gate=ConfidenceGate("max_prob", thr), **kw),
        device="cpu")
    want = j.run(surv, surv.shape[1:])
    got = t.run(torch.from_numpy(surv), surv.shape[1:])
    _same(got, want)
    assert len(surv) == 48 and int(got.escalated.sum()) == 16
    want_bytes = 197_120 if not quantize else 49_728
    assert got.ledger.get("bytes_downlinked") == want_bytes
    if quantize:
        _check_payload(got, surv, surv.shape[1:])


def _f32(cfg):
    return cfg.with_(param_dtype="float32", activation_dtype="float32")


def test_lm_tiers_match_jax():
    """The tiansuan ONBOARD/GROUND pair (fp32, random weights, no
    training) as next-token tiers, as tests/test_lm_cascade.py runs it:
    the JAX tiers through the JAX forward, the bridged ones through the
    port's."""
    tiers = {}
    for name, seed in (("ONBOARD", 0), ("GROUND", 1)):
        jcfg, tcfg = _f32(getattr(JTP, name)), _f32(getattr(TTP, name))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jp = JT.init_params(jax.random.PRNGKey(seed), jcfg, max_seq=32)
        tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")

        def jfn(toks, jp=jp, jcfg=jcfg):
            logits, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   remat=False)
            return np.asarray(logits[:, -1], np.float32)

        def tfn(toks, tp=tp, tcfg=tcfg):
            logits, _ = TT.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
            return logits[:, -1]

        tiers[name] = (jfn, tfn)
    toks = np.random.default_rng(7).integers(
        0, JTP.ONBOARD.vocab_size, (12, 20)).astype(np.int32)
    conf = np.asarray(JGate("max_prob", 1.1).decide(
        jnp.asarray(tiers["ONBOARD"][0](toks)))["confidence"])
    thr = calibrate_threshold(conf, np.ones_like(conf, bool), 0.6)
    kw = dict(item_dtype_bytes=4)
    j = JEngine(tiers["ONBOARD"][0], tiers["GROUND"][0],
                JCascadeConfig(gate=JGate("max_prob", thr), **kw))
    t = CollaborativeEngine(tiers["ONBOARD"][1], tiers["GROUND"][1],
                            CascadeConfig(gate=ConfidenceGate("max_prob", thr),
                                          **kw), device="cpu")
    for avail in (True, False):
        want = j.run(toks, toks.shape[1:], ground_available=avail)
        got = t.run(toks, toks.shape[1:], ground_available=avail)
        _same(got, want)
    assert int(got.escalated.sum()) == 0
    assert int(j.run(toks, toks.shape[1:]).escalated.sum()) == 7
