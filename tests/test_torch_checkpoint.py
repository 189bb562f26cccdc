"""The port's checkpoint store against the JAX package's: its own
MessagePack encoder gives the bytes ``msgpack.packb(obj,
use_bin_type=True)`` gives (on drawn meta dicts and on the scheduler's
real checkpoint) and its decoder reads what ``msgpack`` writes; ``.ckpt``
files cross both ways bit for bit, zstd and raw, fp32 and bf16; a shape
mismatch raises."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import msgpack_codec as mc  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.config import get_reduced_config  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from repro_torch.serving.scheduler import PreemptiveScheduler  # noqa: E402

HAS_ZSTD = store.zstd is not None

_scalars = (st.none() | st.booleans()
            | st.integers(-2 ** 63, 2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@given(st.dictionaries(st.text(max_size=40), _values, max_size=20))
@settings(max_examples=200, deadline=None)
def test_encoder_bytes_equal_msgpack(meta):
    want = msgpack.packb(meta, use_bin_type=True)
    assert mc.packb(meta) == want
    assert mc.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_encoder_length_edges(n):
    for obj in ("x" * n, b"x" * n, [1] * n, {str(i): i for i in range(n)}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert mc.packb(obj) == want
        assert mc.unpackb(want) == msgpack.unpackb(want, raw=False)
    # float32 is read (msgpack writes it on request), never written
    assert mc.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(TypeError):
        mc.packb(np.int64(3))


def _tree(dtype):
    rng = np.random.default_rng(0)
    return {"blocks": {"k": rng.standard_normal((2, 3, 4)).astype(np.float32)
                       .astype(dtype),
                       "v": rng.standard_normal((5,)).astype(np.float32)
                       .astype(dtype)},
            "ids": np.arange(7, dtype=np.int32),
            "embed": rng.standard_normal((4, 2)).astype(dtype)}


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16).view(np.int16) if a.dtype == jnp.bfloat16 else a


CODECS = [True, False] if HAS_ZSTD else [False]


@pytest.mark.parametrize("zstd_on", CODECS)
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_checkpoints_cross_both_ways(tmp_path, monkeypatch, zstd_on, dtype):
    if not zstd_on:
        monkeypatch.setattr(store, "zstd", None)
        monkeypatch.setattr(jstore, "zstd", None)
    tree, meta = _tree(dtype), {"arch": "x", "step": 3, "lr": 1e-3}
    ref_path, port_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    n = jstore.save_checkpoint(ref_path, tree, meta)
    got, got_meta = store.load_checkpoint_raw(ref_path)
    assert got_meta == meta
    want, _ = jstore.load_checkpoint_raw(ref_path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    if dtype is jnp.bfloat16:
        assert got["embed"].dtype == torch.bfloat16
    # the port writes the same file from the tensors it loaded
    m = store.save_checkpoint(port_path, {
        "blocks": {"k": got["blocks/k"], "v": got["blocks/v"]},
        "ids": got["ids"], "embed": got["embed"]}, meta)
    assert m == n
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    back, back_meta = jstore.load_checkpoint_raw(port_path)
    assert back_meta == meta
    for k in want:
        np.testing.assert_array_equal(_bits(back[k]), _bits(want[k]))
    restored, _ = store.load_checkpoint(port_path, {
        "blocks": {"k": torch.zeros(2, 3, 4), "v": torch.zeros(5)},
        "ids": torch.zeros(7), "embed": torch.zeros(4, 2)})
    np.testing.assert_array_equal(_bits(restored["blocks"]["k"]),
                                  _bits(want["blocks/k"]))


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    path = str(tmp_path / "m.ckpt")
    store.save_checkpoint(path, {"w": torch.ones(4, 4)})
    with pytest.raises(ValueError):
        store.load_checkpoint(path, {"w": torch.zeros(2, 2)})
    with pytest.raises(KeyError):
        store.load_checkpoint(path, {"u": torch.zeros(4, 4)})


def test_scheduler_checkpoint_bytes_are_msgpack_bytes(tmp_path):
    """A real serving checkpoint (swapped and active sequences, results,
    counters, extra meta with the lane and the injector state): the file
    the port writes re-encodes to itself through ``msgpack``, and the
    port's decoder reads it as ``msgpack`` does."""
    from repro_torch.core.faults import FaultInjector, FaultPlan
    from repro_torch.core.link import TransmitLane
    cfg = get_reduced_config("smollm-360m").with_(
        param_dtype="float32", activation_dtype="float32")
    eng = ContinuousEngine.init(cfg, seed=0, device="cpu", n_slots=2,
                                max_seq=64, page_size=8)
    sched = PreemptiveScheduler(eng)
    rng = np.random.default_rng(1)
    for n, max_new in ((9, 2), (5, 6), (12, 6)):
        sched.submit(Request(prompt=rng.integers(1, cfg.vocab_size, n)
                             .astype(np.int32), max_new=max_new))
    for _ in range(3):
        sched.step()
    sched.preempt(eng.slots.active_slots()[0])
    for _ in range(2):
        sched.step()
    inj = FaultInjector(FaultPlan(seed=3, frame_loss_rate=0.3))
    lane = TransmitLane(frame_bytes=32, injector=inj)
    lane.enqueue((4, True), 100.0)
    lane.tick(50.0)
    path = str(tmp_path / "s.ckpt")
    sched.checkpoint(path, extra_meta={
        "lane": [[int(r), bool(e), float(nb)]
                 for (r, e), nb in lane.pending_payloads()],
        "lane_state": lane.state(), "faults": inj.state()})
    data = open(path, "rb").read()
    obj = msgpack.unpackb(data, raw=False)
    assert obj["meta"]["sequences"] and obj["meta"]["results"]
    assert msgpack.packb(obj, use_bin_type=True) == data
    assert mc.unpackb(data) == obj
