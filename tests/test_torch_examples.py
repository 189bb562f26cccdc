"""The port's twins of ``examples/*`` (``examples/*_torch.py``) on the
CPU at small settings, each ``main([... "--device", "cpu"])``:

  * what does not depend on the weights' draw equals what the
    reference's own modules give on the same seeds: the EO scene's
    filter rate and survivor count and its bent-pipe bytes, the compute
    share of energy, the federated rounds' staleness weights;
  * the rest makes sense: the quickstart's loss falls, its checkpoint
    loads into the reference's ``load_checkpoint`` leaf for leaf, the
    collaborative accuracy is at least the in-orbit one and the
    downlinked bytes below the bent-pipe's, the federated losses are
    finite;
  * each defaults to the card and raises without one."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart_torch", "collaborative_inference_torch",
         "federated_constellation_torch")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _twin(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the loss of two steps' batches differ by their draw more than by the
# first updates (6.277 then 6.299); ten steps fall by 0.38
QUICK_STEPS = 10


def test_quickstart_trains_checkpoints_and_generates(tmp_path, capsys):
    from repro.checkpoint import load_checkpoint as j_load
    from repro.config import get_reduced_config as j_reduced
    from repro.models import transformer as JT
    from repro_torch.checkpoint.store import load_checkpoint_raw
    path = str(tmp_path / "model.ckpt")
    out = _twin("quickstart_torch").main(["--device", "cpu", "--steps",
                                          str(QUICK_STEPS), "--checkpoint",
                                          path])
    printed = capsys.readouterr().out
    assert "step  10 loss" in printed
    assert "[4/4] generated continuations:" in printed
    losses = out["losses"]     # each step's, on its own batch
    assert len(losses) == QUICK_STEPS and losses[-1] < losses[0] - 0.1
    assert np.asarray(out["tokens"]).shape == (2, 12)
    cfg = j_reduced("smollm-360m")
    like = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg,
                                                 max_seq=128))
    theirs, meta = j_load(path, like)
    assert meta["arch"] == out["arch"] == cfg.name
    mine, _ = load_checkpoint_raw(path)
    flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(theirs)[0]}
    assert set(flat) == set(mine)
    for key, leaf in mine.items():
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      flat[key].astype(np.float32),
                                      err_msg=key)


COLLAB = ["--train-tiles", "400", "--onboard-steps", "60",
          "--ground-steps", "120", "--frames", "200"]


def test_collaborative_inference_filters_gates_and_escalates():
    import jax.numpy as jnp
    from repro.core.energy import EnergyModel as JEnergy
    from repro.core.filtering import filter_tiles as j_filter
    from repro.data import eo as JEO
    out = _twin("collaborative_inference_torch").main(
        ["--device", "cpu", *COLLAB])
    scene = JEO.EOConfig(cloud_fraction=0.86, dup_fraction=0.30,
                         contrast=0.55, noise=0.24, seed=1)
    frames, labels, _ = JEO.make_tiles(200, scene)
    keep, stats = j_filter(jnp.asarray(frames))
    keep = np.asarray(keep)
    assert out["survivors"] == int(keep.sum()) > 0
    assert out["filter_rate"] == pytest.approx(float(stats["filter_rate"]),
                                               abs=1e-7)
    assert out["labeled"] == int((labels[keep] >= 0).sum())
    assert out["bytes_bentpipe"] == frames.nbytes
    assert out["compute_share"] == JEnergy().compute_share_of_total()
    assert out["collaborative_accuracy"] >= out["inorbit_accuracy"]
    assert 0 < out["escalated"] < out["survivors"]
    assert out["bytes_downlinked"] < out["bytes_bentpipe"]


def test_federated_rounds_weigh_by_staleness():
    from repro.config import get_reduced_config as j_reduced
    from repro.data.tokens import TokenStream, TokenStreamConfig
    from repro.training.federated import FedConfig, run_federated
    out = _twin("federated_constellation_torch").main(
        ["--device", "cpu", "--rounds", "2", "--local-steps", "1"])
    cfg = j_reduced("smollm-360m")
    want = run_federated(
        cfg, FedConfig(n_satellites=3, local_steps=1, rounds=2),
        lambda i: iter(TokenStream(TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
            seed=1000 + i))), max_seq=64)
    assert [r["weights"] for r in out["rounds"]] == \
        [r["weights"] for r in want["rounds"]]
    assert [r["round"] for r in out["rounds"]] == [0, 1]
    assert all(np.isfinite(r["local_losses"]).all() for r in out["rounds"])
    assert np.isfinite(out["held_out_loss"])


@pytest.mark.parametrize("name", TWINS)
def test_twins_default_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(name).main([])
