"""The port's cloud-native layer, the KubeEdge/Sedna analogue: twins of
``tests/test_orchestration.py``'s six tests on
``repro_torch.orchestration`` (registry liveness, contact-gated message
delivery, deployment and offline-autonomy restore), then Sedna's
learning paradigms (``repro_torch.training.{federated,incremental,
lifelong}``) against the JAX package's on the same weights and streams:
FedAvg exactly, one federated round, one incremental and one lifelong
update of 2 steps each, on the tiansuan ONBOARD tier's reduced widths in
fp32, the JAX params bridged into the port.

Tolerances: FedAvg is bit-exact (the same fp32 products and sums in the
same order).  Params after the 2-step updates: atol 1e-4, the training
tests' bound (``tests/test_torch_training.py``: AdamW's ~unit step turns
last-bit gradient differences of near-zero entries into step
differences); logged losses atol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_reduced_config as j_reduced  # noqa: E402
from repro.data.tokens import TokenStream as JStream  # noqa: E402
from repro.data.tokens import TokenStreamConfig as JStreamConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import federated as JF  # noqa: E402
from repro.training import incremental as JI  # noqa: E402
from repro.training import lifelong as JLL  # noqa: E402
from repro.training import loop as JL  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_reduced_config as t_reduced  # noqa: E402
from repro_torch.core.link import ContactSchedule  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.orchestration import (AppManifest, Deployer,  # noqa: E402
                                       MessageBus, MetadataStore, NodeSpec,
                                       Registry)
from repro_torch.training import federated as TF  # noqa: E402
from repro_torch.training import incremental as TI  # noqa: E402
from repro_torch.training import lifelong as TLL  # noqa: E402
from repro_torch.training import loop as TL  # noqa: E402
from repro_torch.training import optim as TO  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")
ARCH = "tiansuan_pair"                      # reduced: tiansuan ONBOARD
SEQ, BATCH, STEPS = 32, 2, 2
PARAM_ATOL, LOSS_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small shapes: one intra-op thread for this file (the suite runs
    files in parallel workers), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# orchestration: twins of tests/test_orchestration.py
# --------------------------------------------------------------------------

@pytest.fixture
def cluster():
    reg = Registry()
    reg.register(NodeSpec("baoyun", "satellite",
                          contacts=ContactSchedule(seed=3)))
    reg.register(NodeSpec("ground-0", "ground"))
    return reg


def test_registry_reachability_follows_contacts(cluster):
    sat = cluster.get("baoyun")
    wins = sat.contacts.windows(86_400.0)
    inside = 0.5 * (wins[0][0] + wins[0][1])
    outside = wins[0][1] + 30.0
    assert cluster.reachable("baoyun", inside)
    assert not cluster.reachable("baoyun", outside)
    assert cluster.reachable("ground-0", outside)


def test_bus_delivers_only_in_contact_windows(cluster):
    bus = MessageBus(cluster)
    got = []
    bus.subscribe("ground-0", "results", lambda m: got.append(m))
    sat = cluster.get("baoyun")
    win = sat.contacts.windows(86_400.0)[0]
    # send long before the window: must arrive at/after window start
    dt = bus.send("baoyun", "ground-0", "results", {"x": 1},
                  nbytes=10_000, t=0.0)
    assert dt is not None and dt >= win[0]
    bus.advance(win[0] - 1.0)
    assert not got
    bus.advance(dt + 1e-6)
    assert len(got) == 1 and got[0].payload == {"x": 1}


def test_bus_ground_to_ground_instant(cluster):
    cluster.register(NodeSpec("cloud", "ground"))
    bus = MessageBus(cluster)
    got = []
    bus.subscribe("cloud", "sync", lambda m: got.append(m))
    dt = bus.send("ground-0", "cloud", "sync", b"tick", nbytes=64, t=5.0)
    assert dt == 5.0
    bus.advance(5.0)
    assert got


def test_large_transfer_spills_to_next_window(cluster):
    bus = MessageBus(cluster)
    sat = cluster.get("baoyun")
    w0, w1 = sat.contacts.windows(86_400.0)[:2]
    # a transfer bigger than one window's capacity at 40 Mbps
    window_cap = (w0[1] - w0[0]) * 40e6 / 8 * 0.95
    dt = bus.send("baoyun", "ground-0", "bulk", None,
                  nbytes=int(window_cap * 2), t=w0[0])
    assert dt is not None and dt >= w1[0]


def test_deployer_and_offline_restore(tmp_path, cluster):
    store = MetadataStore(str(tmp_path / "meta.json"))
    dep = Deployer(cluster, store)
    made = []
    manifest = AppManifest("onboard-infer", "baoyun",
                           factory=lambda: made.append(1) or "worker-1")
    dep.apply(manifest)
    assert dep.worker("onboard-infer") == "worker-1"
    assert store.actual("onboard-infer") == "running"

    # simulate satellite restart: new deployer, same metadata file
    store2 = MetadataStore(str(tmp_path / "meta.json"))
    store2.record_actual("onboard-infer", "dead")
    dep2 = Deployer(cluster, store2)
    n = dep2.restore({"onboard-infer": lambda: "worker-2"})
    assert n == 1
    assert dep2.worker("onboard-infer") == "worker-2"


def test_deployer_rejects_unknown_node(cluster):
    dep = Deployer(cluster)
    with pytest.raises(KeyError):
        dep.apply(AppManifest("x", "nonexistent", factory=lambda: None))


def test_contact_queries_match_reference():
    """``in_contact`` and ``next_window``, which the registry, the bus
    and federated staleness read, against the JAX package's link."""
    from repro.core.link import ContactSchedule as JSchedule
    for seed in (0, 3, 7):
        js, ts = JSchedule(seed=seed), ContactSchedule(seed=seed)
        for t in np.linspace(0.0, 90_000.0, 181):
            assert ts.in_contact(t) == js.in_contact(t)
            assert ts.next_window(t) == js.next_window(t)


# --------------------------------------------------------------------------
# Sedna's learning paradigms against the JAX package's
# --------------------------------------------------------------------------

def _pair():
    jcfg, tcfg = j_reduced(ARCH).with_(**F32), t_reduced(ARCH).with_(**F32)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, max_seq=SEQ)
    return jcfg, tcfg, jparams, params_from_numpy(jax.device_get(jparams),
                                                  tcfg, device="cpu")


def _streams(vocab, seed):
    kw = dict(vocab_size=vocab, seq_len=SEQ, batch_size=BATCH, seed=seed)
    return JStream(JStreamConfig(**kw)), TokenStream(TokenStreamConfig(**kw))


def _by_path(tree) -> dict:
    return {"/".join(p): np.asarray(x, np.float32)
            for p, x in tree_leaves_with_path(tree)}


def _close_params(got, want):
    want = _by_path(jax.device_get(want))
    got = _by_path(got)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=PARAM_ATOL, rtol=0,
                                   err_msg=path)


def _close_history(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for tr, jr in zip(got, want):
        np.testing.assert_allclose(tr["loss"], jr["loss"], atol=LOSS_ATOL)


def test_fedavg_is_exact():
    """Staleness-weighted FedAvg, fp32 and bf16 leaves, unequal weights
    with residual weight on the global, and all-zero weights."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 5), "b": (7,)}
    trees = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for bf16 in (False, True):
        jt = [{k: jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32)
               for k, v in t.items()} for t in trees]
        tt = [{k: torch.from_numpy(v).to(torch.bfloat16 if bf16
                                         else torch.float32)
               for k, v in t.items()} for t in trees]
        for weights in ([0.7, 0.2], [1.0, 3.0], [0.0, 0.0], [0.25, 0.5]):
            want = JF.fedavg(jt[0], jt[1:], weights)
            got = TF.fedavg(tt[0], tt[1:], weights)
            for k in shapes:
                assert got[k].dtype == tt[0][k].dtype
                np.testing.assert_array_equal(
                    got[k].float().numpy(),
                    np.asarray(want[k].astype(jnp.float32)))


def test_one_federated_round_matches_reference(monkeypatch):
    """One round over 2 satellites of 2 local steps each, on their own
    shards (seeds 100 + i): the staleness weights from each satellite's
    next contact are equal, local losses and the aggregated params
    close.  The port's round starts from the reference's params
    (``init_state`` bridged in)."""
    jcfg, tcfg, jparams, tparams = _pair()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
    fed = dict(n_satellites=2, local_steps=STEPS, rounds=1)
    want = JF.run_federated(
        jcfg, JF.FedConfig(**fed),
        lambda i: iter(_streams(jcfg.vocab_size, 100 + i)[0]),
        opt_cfg=JO.OptimConfig(**opt), max_seq=SEQ)
    monkeypatch.setattr(TF, "init_state", lambda cfg, o, seed, device:
                        TL.TrainState(params=tparams,
                                      opt_state=TO.adamw_init(tparams, o)))
    got = TF.run_federated(
        tcfg, TF.FedConfig(**fed),
        lambda i: iter(_streams(tcfg.vocab_size, 100 + i)[1]),
        opt_cfg=TO.OptimConfig(**opt), device="cpu")
    (jr,), (tr,) = want["rounds"], got["rounds"]
    assert tr["weights"] == jr["weights"] and 0 < min(tr["weights"]) <= 1
    np.testing.assert_allclose(tr["local_losses"], jr["local_losses"],
                               atol=LOSS_ATOL)
    _close_params(got["global_params"], want["global_params"])


def test_incremental_update_matches_reference():
    jcfg, tcfg, jparams, tparams = _pair()
    inc = dict(finetune_steps=STEPS, lr=2e-3)
    js, ts = _streams(jcfg.vocab_size, 999)
    opt = dict(lr=1e-3)
    jst = JL.TrainState(params=jparams, opt_state=JO.adamw_init(
        jparams, JO.OptimConfig(**opt)), step=30)
    tst = TL.TrainState(params=tparams, opt_state=TO.adamw_init(
        tparams, TO.OptimConfig(**opt)), step=30)
    jst = JI.incremental_update(jcfg, jst, iter(js),
                                inc=JI.IncrementalConfig(**inc))
    tst = TI.incremental_update(tcfg, tst, iter(ts),
                                inc=TI.IncrementalConfig(**inc))
    assert tst.step == jst.step == 30 + STEPS
    _close_history(tst.history, jst.history)
    _close_params(tst.params, jst.params)


def test_lifelong_update_matches_reference():
    """A lifelong update on a second task after a first is in the
    library: rehearsal batches drawn from the library's replay buffers
    as the reference draws them, the new task registered with its
    reserve batches and its snapshot."""
    jcfg, tcfg, jparams, tparams = _pair()
    ll = dict(steps_per_task=STEPS, rehearsal_ratio=0.5, lr=1e-3)
    libs = (JLL.KnowledgeLibrary(max_batches_per_task=2),
            TLL.KnowledgeLibrary(max_batches_per_task=2))
    old_j, old_t = _streams(jcfg.vocab_size, 10)
    libs[0].register("taskA", [old_j.batch(i) for i in range(2)])
    libs[1].register("taskA", [old_t.batch(i) for i in range(2)])
    new_j, new_t = _streams(jcfg.vocab_size, 20)
    opt = dict(lr=1e-3)
    jst = JLL.lifelong_update(
        jcfg, JL.TrainState(params=jparams, opt_state=JO.adamw_init(
            jparams, JO.OptimConfig(**opt))), "taskB", iter(new_j), libs[0],
        ll=JLL.LifelongConfig(**ll))
    tst = TLL.lifelong_update(
        tcfg, TL.TrainState(params=tparams, opt_state=TO.adamw_init(
            tparams, TO.OptimConfig(**opt))), "taskB", iter(new_t), libs[1],
        ll=TLL.LifelongConfig(**ll))
    assert libs[1].tasks() == libs[0].tasks() == ["taskA", "taskB"]
    for a, b in zip(libs[1].replay["taskB"], libs[0].replay["taskB"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    _close_history(tst.history, jst.history)
    _close_params(tst.params, jst.params)
    _close_params(libs[1].snapshots["taskB"], libs[0].snapshots["taskB"])
