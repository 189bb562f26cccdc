"""The port's EO case-study modules against the JAX package's, on the
same numpy inputs, on the CPU: the synthetic tiles (byte-identical),
tiling (exact), the cloud and redundancy filters (identical masks, the
paper's Figure 6 rates), the tile classifiers on bridged params, the
AdamW step and schedule, 20 training steps from the same start, and the
numpy-only copies (ledger, link, energy, threshold calibration).

Tolerances: classifier logits atol 1e-5 (the same fp32 matmuls, summed
in another order by XLA and by PyTorch's CPU kernels); the schedule and
one AdamW step 1e-6; 20 training steps 1e-4 on params and loss (the
step's update divides by sqrt(vhat), so last-bit differences of the
gradients grow over the steps)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import classifier as JCL  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import filtering as jfilt  # noqa: E402
from repro.core import gating as jgating  # noqa: E402
from repro.core import link as jlink  # noqa: E402
from repro.core import telemetry as jtele  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.data import eo as jeo  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.training import optim as jopt  # noqa: E402
from repro_torch.bridge import classifier_params_from_numpy  # noqa: E402
from repro_torch.core import classifier as TCL  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import filtering as tfilt  # noqa: E402
from repro_torch.core import gating as tgating  # noqa: E402
from repro_torch.core import link as tlink  # noqa: E402
from repro_torch.core import telemetry as ttele  # noqa: E402
from repro_torch.core import tiling as ttiling  # noqa: E402
from repro_torch.data import eo as teo  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.training import optim as topt  # noqa: E402

# fig7_accuracy's v1 regime (benchmarks/fig7_accuracy.py REGIMES)
FIG7_V1 = dict(cloud_fraction=0.0, dup_fraction=0.0, contrast=0.42,
               noise=0.26, seed=21)
TIER = {"onboard": (JCL.ONBOARD, TCL.ONBOARD),
        "ground": (JCL.GROUND, TCL.GROUND)}


def _tiles(version, n=600):
    return jeo.make_tiles(n, {"v1": jeo.V1, "v2": jeo.V2}[version])


def _bridged(tier, seed=0):
    jcfg, tcfg = TIER[tier]
    jcfg = dataclasses.replace(jcfg, seed=seed)
    jp = JCL.init_classifier(jcfg)
    return jcfg, tcfg, jp, classifier_params_from_numpy(
        jax.device_get(jp), tcfg, device="cpu")


def _close_trees(t, j, atol):
    for k, v in j.items():
        if isinstance(v, dict):
            _close_trees(t[k], v, atol)
        else:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(v),
                                       atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("which", ["v1", "v2", "fig7_v1"])
def test_make_tiles_byte_identical(which):
    if which == "fig7_v1":
        want = jeo.make_tiles(150, jeo.EOConfig(**FIG7_V1))
        got = teo.make_tiles(150, teo.EOConfig(**FIG7_V1))
    else:
        want = jeo.make_tiles(150, getattr(jeo, which.upper()))
        got = teo.make_tiles(150, getattr(teo, which.upper()))
    assert dataclasses.asdict(teo.V1) == dataclasses.asdict(jeo.V1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("H,W", [(70, 45), (64, 96), (33, 97)])
def test_tiling_matches_jax(H, W):
    rng = np.random.default_rng(H * W)
    frames = rng.random((3, H, W, 3)).astype(np.float32)
    t = 16
    assert ttiling.tile_grid(H, W, t) == jtiling.tile_grid(H, W, t)
    got = ttiling.split_frame(torch.from_numpy(frames[0]), t)
    want = np.asarray(jtiling.split_frame(jnp.asarray(frames[0]), t))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ttiling.merge_tiles(got, H, W).numpy(),
                                  frames[0])
    np.testing.assert_array_equal(
        ttiling.split_batch(torch.from_numpy(frames), t).numpy(),
        np.asarray(jtiling.split_batch(jnp.asarray(frames), t)))


@pytest.mark.parametrize("version,rate", [("v1", 0.902), ("v2", 0.370)])
def test_filters_match_jax(version, rate, monkeypatch):
    """Figure 6 on 600 tiles: identical cloud, redundancy and keep masks
    and the reference's filter rate (the fp32 means of identical masks
    may differ in their last bit); the redundancy mask is also the same
    when taken in blocks of 7 rows."""
    tiles = _tiles(version)[0]
    jt, tt = jnp.asarray(tiles), torch.from_numpy(tiles)
    np.testing.assert_array_equal(tfilt.cloud_mask(tt).numpy(),
                                  np.asarray(jfilt.cloud_mask(jt)))
    np.testing.assert_allclose(
        tfilt.tile_signature(tt, 4).numpy(),
        np.asarray(jfilt.tile_signature(jt, 4)), atol=1e-6, rtol=0)
    dup = tfilt.redundancy_mask(tt)
    np.testing.assert_array_equal(dup.numpy(),
                                  np.asarray(jfilt.redundancy_mask(jt)))
    monkeypatch.setattr(tfilt, "_BLOCK_ELEMS", 7 * 600 * 16)
    np.testing.assert_array_equal(tfilt.redundancy_mask(tt).numpy(),
                                  dup.numpy())
    keep, stats = tfilt.filter_tiles(tt)
    jkeep, jstats = jfilt.filter_tiles(jt)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert stats["n_tiles"] == jstats["n_tiles"] == 600
    for k in ("cloud_rate", "dup_rate", "filter_rate"):
        # means of identical masks, each rounded once to fp32 by its side
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   atol=1e-7, rtol=0, err_msg=k)
    assert round(float(stats["filter_rate"]), 3) == rate


def test_layers_init_names_and_shapes():
    jm = JL.init_swiglu(jax.random.PRNGKey(0), 24, 96, jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tm = TL.init_swiglu(gen, 24, 96, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tm.items()} == \
        {k: v.shape for k, v in jm.items()}
    tn, jn = TL.init_rmsnorm(24, torch.float32, "cpu"), \
        JL.init_rmsnorm(24, jnp.float32)
    np.testing.assert_array_equal(tn["scale"].numpy(), np.asarray(jn["scale"]))


@pytest.mark.parametrize("tier", ["onboard", "ground"])
def test_apply_classifier_matches_jax(tier):
    jcfg, tcfg, jp, tp = _bridged(tier)
    # the port's own init has the reference's tree, leaf for leaf
    init = TCL.init_classifier(tcfg, device="cpu")
    classifier_params_from_numpy(topt.tree_map(lambda t: t.numpy(), init),
                                 tcfg, device="cpu")
    tiles, labels, _ = jeo.make_tiles(40, jeo.EOConfig(**FIG7_V1))
    got = TCL.apply_classifier(tp, tcfg, torch.from_numpy(tiles))
    want = np.asarray(JCL.apply_classifier(jp, jcfg, jnp.asarray(tiles)))
    assert got.shape == (40, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert TCL.accuracy(tp, tcfg, tiles, labels) == \
        JCL.accuracy(jp, jcfg, tiles, labels)


def test_bridge_rejects_a_classifier_of_other_widths():
    _, _, jp, _ = _bridged("onboard")
    with pytest.raises(ValueError, match="classifier params"):
        classifier_params_from_numpy(jax.device_get(jp), TCL.GROUND,
                                     device="cpu")


def test_lr_schedule_and_adamw_step_match_jax():
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=120, weight_decay=0.01)
    jc, tc = jopt.OptimConfig(**cfg), topt.OptimConfig(**cfg)
    for step in (0, 1, 7, 19, 20, 21, 64, 119, 120, 400):
        np.testing.assert_allclose(
            float(topt.lr_schedule(tc, step)),
            float(jopt.lr_schedule(jc, jnp.asarray(step))), atol=1e-6,
            rtol=0, err_msg=str(step))
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32),
                  "d": rng.standard_normal((3, 2)).astype(np.float32)}}
    grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 2)
                         .astype(np.float32), tree)
    state_j = jopt.adamw_init(jax.tree.map(jnp.asarray, tree), jc)
    # a state some steps in: moments nonzero, step 5
    state_j = {"mu": jax.tree.map(lambda g: jnp.asarray(0.1 * g), grads),
               "nu": jax.tree.map(lambda g: jnp.asarray(0.01 * g * g), grads),
               "step": state_j["step"] + 5}
    pj, sj, mj = jopt.adamw_update(jax.tree.map(jnp.asarray, tree),
                                   jax.tree.map(jnp.asarray, grads), state_j,
                                   jc)
    as_t = lambda t: topt.tree_map(torch.from_numpy, t)  # noqa: E731
    state_t = {"mu": as_t(jax.device_get(state_j["mu"])),
               "nu": as_t(jax.device_get(state_j["nu"])),
               "step": torch.tensor(5, dtype=torch.int32)}
    pt, st, mt = topt.adamw_update(as_t(tree), as_t(grads), state_t, tc)
    assert int(st["step"]) == int(sj["step"]) == 6
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), atol=1e-6,
                                   rtol=0)
    _close_trees(pt, jax.device_get(pj), 1e-6)
    _close_trees(st["mu"], jax.device_get(sj["mu"]), 1e-6)
    _close_trees(st["nu"], jax.device_get(sj["nu"]), 1e-6)
    fresh = topt.adamw_init(as_t(tree),
                            topt.OptimConfig(moment_dtype="bfloat16"))
    assert fresh["mu"]["b"]["c"].dtype == torch.bfloat16
    assert int(fresh["step"]) == 0


@pytest.mark.parametrize("tier", ["onboard", "ground"])
def test_train_classifier_matches_jax(tier):
    """20 steps from the reference's initial params, on the same batch
    indices (np.random.default_rng(seed).integers)."""
    jcfg, tcfg, jp, tp = _bridged(tier)
    tiles, labels, _ = jeo.make_tiles(300, jeo.EOConfig(**FIG7_V1))
    jtrained, jloss = JCL.train_classifier(jcfg, tiles, labels, steps=20)
    ttrained, tloss = TCL.train_classifier(tcfg, tiles, labels, steps=20,
                                           params=tp)
    assert abs(tloss - jloss) <= 1e-4
    _close_trees(ttrained, jax.device_get(jtrained), 1e-4)
    assert ttrained["embed"].requires_grad is False


def test_numpy_copies_match_jax():
    """Ledger, link, energy and the gate's calibration are copies: the
    same inputs give the same numbers."""
    jl, tl = jtele.Ledger(), ttele.Ledger()
    for led in (jl, tl):
        led.add("items_total", 10)
        led.add("items_escalated", 3)
        led.add("bytes_downlinked", 1234)
        led.add("bytes_bentpipe_baseline", 40960)
    assert tl.summary() == jl.summary()
    assert tl.ratio("items_escalated", "items_total") == \
        jl.ratio("items_escalated", "items_total")
    jlm, tlm = jlink.LinkModel(), tlink.LinkModel()
    assert dataclasses.asdict(tlm) == dataclasses.asdict(jlm)
    assert tlm.orbital_period_s == jlm.orbital_period_s
    for nb in (0, 1000, 123457):
        assert tlm.downlink_time_s(nb) == jlm.downlink_time_s(nb)
        assert tlm.uplink_time_s(nb) == jlm.uplink_time_s(nb)
        assert tlm.deliver(nb, np.random.default_rng(nb)) == \
            jlm.deliver(nb, np.random.default_rng(nb))
    assert tlink.payload_bytes_result(7, 3) == jlink.payload_bytes_result(7, 3)
    assert tlink.payload_bytes_raw(5, (32, 32, 3), 4) == \
        jlink.payload_bytes_raw(5, (32, 32, 3), 4)
    assert tlink.payload_bytes_draft(8) == jlink.payload_bytes_draft(8)
    je, te = jenergy.EnergyModel(), tenergy.EnergyModel()
    for f in ("compute_share_of_total", "compute_share_of_payload",
              "payload_share_of_total"):
        assert getattr(te, f)() == getattr(je, f)()
    assert te.inference_energy_j(48, 0.35) == je.inference_energy_j(48, 0.35)
    assert te.comm_energy_j(2.5) == je.comm_energy_j(2.5)
    assert te.energy_budget_j(5400.0) == je.energy_budget_j(5400.0)
    conf = np.random.default_rng(0).random(37).astype(np.float32)
    for budget in (0.0, 0.35, 0.45, 1.0):
        assert tgating.calibrate_threshold(conf, None, budget) == \
            jgating.calibrate_threshold(conf, None, budget)
    a, b = conf > 0.3, conf > 0.6
    assert tgating.accuracy_with_gate(a, b, conf < 0.5) == \
        jgating.accuracy_with_gate(a, b, conf < 0.5)
