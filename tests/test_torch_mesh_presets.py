"""The reference's mesh presets that the port runs since the MoE's token
exchange, on the CPU: one 4-rank gloo world
(``repro_torch.launch.mesh.spawn``; the ranks run
tests/mesh_presets_ranks.py, which imports no JAX) on a (2, 2) mesh.

  * ``ep`` (experts over both axes, one a rank here; the tokens over
    "data", so each rank sends its routings to the experts' owners
    through ``Mesh.all_to_all``) and ``dp`` with experts (experts over
    "model", the tokens over both axes) for reduced qwen3-moe (4
    experts) and deepseek-v3 (MLA, MoE with a shared expert, MTP);
  * training under ``infer-tp`` (no FSDP) and ``infer-tp2`` (every
    weight over both axes, the batch whole) for smollm (8/4 heads of
    32) and qwen3-moe.

Training: two fp32 steps of ``make_train_step(mesh=...)`` against the
reference's UNSHARDED ``make_train_step`` on the same params and
batches, at tests/test_torch_mesh_training.py's tolerances (its
docstring states them and why), with the dropped routings of each step
summed over the ranks that hold other rows equal to the unsharded
step's, and some dropped.  Serving: ``make_prefill_step`` into a cache
of 24 positions and 4 greedy ``make_serve_step`` steps under ``ep`` and
``dp`` against the reference's unsharded ``prefill`` and
``decode_step``, logits within 1e-4 (as tests/test_torch_seq_decode.py),
tokens identical, each cache leaf the reference rule's slice; a prefill
under the engines' capacity bound overflows as many routings as on one
rank, on every rank.  Also held: each rank's param and moment slices
equal to the rule's, no expert weight whole under ``ep``; the dry-run's
``CountingMesh`` issues each step's collectives, all-to-all included,
kind by kind with their bytes, as the world did; and ``Mesh.all_to_all``
exchanged twice returns every tensor bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mesh_presets_ranks as R  # noqa: E402
import mesh_train_ranks as TR  # noqa: E402
import seq_decode_ranks as SR  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from test_sharding import _params_for  # noqa: E402
from test_torch_mesh_training import (  # noqa: E402
    METRIC_ATOL, METRICS, MU_TOL, NU_TOL, _close, _close_params, _flat)
from test_torch_seq_decode import (LOGITS_ATOL, _np, _positions,  # noqa: E402
                                   _rule_shapes)

N_RANKS = 4
TRAIN = {name: (arch, preset) for name, arch, preset in R.TRAIN}
SERVE = {name: (arch, preset) for name, arch, preset in R.SERVE}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """Training, per arch: the reference's params (numpy) and after each
    step of its unsharded ``make_train_step`` its metrics, params and
    moments.  Serving, per arch: its params, and the logits and greedy
    tokens of its unsharded prefill (its cache laid out for the test's
    positions) and decode steps."""
    opt = JO.OptimConfig(**{k: getattr(TR.OPT, k) for k in (
        "lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
        "weight_decay", "grad_clip", "moment_dtype")})
    train = {}
    for arch in sorted({a for a, _ in TRAIN.values()}):
        cfg = TR.serving_cfg(arch)
        params = _params_for(cfg)
        np_params = jax.device_get(params)
        state = JO.adamw_init(params, opt)
        step = jax.jit(JS.make_train_step(cfg, opt))
        rows = []
        for toks in TR.batches(cfg):
            params, state, m = step(params, state,
                                    {"tokens": jnp.asarray(toks)})
            rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                             params=_flat(jax.device_get(params)),
                             mu=_flat(jax.device_get(state["mu"])),
                             nu=_flat(jax.device_get(state["nu"]))))
        train[arch] = dict(params=np_params, steps=rows)
    serve = {}
    for arch in sorted({a for a, _ in SERVE.values()}):
        cfg = SR.config(arch)
        params = jax.jit(lambda k: JT.init_params(k, cfg, max_seq=64))(
            jax.random.PRNGKey(0))
        logits, cache = jax.jit(lambda p, t: JT.prefill(
            p, cfg, {"tokens": t}))(params, jnp.asarray(SR.prompts(cfg)))
        cache = jax.tree_util.tree_map(
            lambda a: jnp.asarray(_positions(np.asarray(a), SR.MAX_SEQ)),
            cache)
        step = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
        out, tokens = [np.asarray(logits[:, 0])], []
        for t in range(SR.DECODE_STEPS):
            nxt = np.asarray(jnp.argmax(logits[:, 0], -1)).astype(np.int32)
            tokens.append(nxt)
            logits, cache = step(params, cache, jnp.asarray(nxt[:, None]),
                                 jnp.int32(SR.PROMPT + t))
            out.append(np.asarray(logits[:, 0]))
        serve[arch] = dict(params=_np(params), logits=out, tokens=tokens,
                           cfg=cfg)
    return dict(train=train, serve=serve)


@pytest.fixture(scope="module")
def world(reference):
    train = {a: v["params"] for a, v in reference["train"].items()}
    serve = {a: v["params"] for a, v in reference["serve"].items()}
    return spawn(R.run_world, N_RANKS, train, serve, device="cpu",
                 threads=1, timeout_s=300)


def _distinct_rows(world, preset: str) -> list:
    """The ranks holding distinct rows of the batch under ``preset`` on
    the (2, 2) mesh: ``ep``, ``infer-tp``: the "model" index 0 of each
    data row; ``dp``: every rank; ``infer-tp2``: rank 0."""
    keep = {"ep": lambda c: c["model"] == 0,
            "infer-tp": lambda c: c["model"] == 0,
            "dp": lambda c: True,
            "infer-tp2": lambda c: c == {"data": 0, "model": 0}}[preset]
    return [r for r in world if keep(r["coord"])]


@pytest.mark.parametrize("case", list(TRAIN))
def test_preset_steps_match_the_unsharded_reference(case, world, reference):
    arch, preset = TRAIN[case]
    ref = reference["train"][arch]["steps"]
    rows = [r[("train", case)] for r in world]
    for s, want in enumerate(ref):
        got = [r["steps"][s] for r in rows]
        for k in METRICS:
            w = want["metrics"][k]
            for g in got:       # the whole batch's, equal on every rank
                assert g["metrics"][k] == got[0]["metrics"][k], (k, s)
            np.testing.assert_allclose(
                got[0]["metrics"][k], w, atol=METRIC_ATOL * max(1.0, abs(w)),
                err_msg=f"{case} step {s} {k}")
        r0 = got[0]
        _close_params(r0["params"], ref, s + 1, f"{case} step {s}")
        _close(r0["mu"], want["mu"], *MU_TOL, f"{case} step {s} mu",
               unembed_ulps=1)
        _close(r0["nu"], want["nu"], *NU_TOL, f"{case} step {s} nu",
               unembed_ulps=2)


@pytest.mark.parametrize("case", list(TRAIN))
def test_each_rank_holds_the_rule_slices(case, world):
    """Each rank's params and moments have the rule's shapes
    (``param_plan`` on the whole shapes); under ``ep`` each rank holds
    one expert of each stacked expert leaf (none gathered whole: its
    FSDP cut is dropped, as the reference's duplicate guard drops it)
    and under ``dp`` half of them, FSDP-cut over "data"."""
    arch, preset = TRAIN[case]
    want = TR.local_shapes(arch, preset, R.MESH)
    cfg = TR.serving_cfg(arch)
    for r in world:
        got = r[("train", case)]
        assert got["shapes"] == want and got["moment_shapes"] == want
        if cfg.moe is None:
            continue
        for path, shape in got["shapes"].items():
            if "moe" in path and path.split("/")[-1] in (
                    "w_gate", "w_up", "w_down") and "shared" not in path:
                E = cfg.moe.n_experts
                n = {"ep": 4, "dp": 2, "infer-tp": 2, "infer-tp2": 4}[preset]
                assert shape[-3] == E // n, (path, shape)
                whole = TR.local_shapes(arch, "infer-tp2", (1, 1))[path]
                cut = sum(a != b for a, b in zip(shape[-2:], whole[-2:]))
                assert cut == (1 if preset == "dp" else 0), (path, shape)


@pytest.mark.parametrize("case", list(TRAIN))
def test_counting_mesh_predicts_the_world_collectives(case, world):
    """The dry-run's step (``launch.dryrun``: the same step built on the
    meta device on a ``CountingMesh``, rank 0, gloo's path on CPU
    tensors, where a reduce-scatter is gloo's own) issues each
    kind of collective on each axis as often, with as many result bytes,
    as every step of the world did on every rank; the exchange's
    all-to-alls run exactly where the experts and the tokens share an
    axis: "data" under ``ep``, "model" under ``dp``, six a MoE layer
    (there and back in the forward, again in remat's recompute, and
    each one's reverse in the backward)."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    arch, preset = TRAIN[case]
    cfg = TR.serving_cfg(arch)
    res = dryrun_one(arch, ShapeSpec(case, TR.SEQ, TR.BATCH, "train"),
                     mesh=R.MESH, sharding=preset, backend="gloo-cpu",
                     cfg=cfg, verbose=False)
    want = {a: {k: (v["count"], v["bytes"]) for k, v in kinds.items()
                if k != "link_bytes" and v["count"]}
            for a, kinds in res["collectives_by_axis"].items()}
    for r in world:
        for step in r[("train", case)]["steps"]:
            assert step["kinds"] == want, (r["rank"], step["kinds"], want)
    a2a = {a: kinds.get("all-to-all", (0, 0))[0]
           for a, kinds in want.items()}
    moe_layers = (cfg.n_layers - cfg.moe.n_dense_layers
                  if cfg.moe is not None else 0)
    axis = {"ep": "data", "dp": "model"}.get(preset)
    for a, n in a2a.items():
        assert n == (6 * moe_layers if a == axis else 0), (a2a, preset)


@pytest.mark.parametrize("case", [c for c, (a, _) in TRAIN.items()
                                  if TR.serving_cfg(a).moe is not None])
def test_moe_drops_equal_the_unsharded_step(case, world, reference):
    """Each step's dropped routings, summed over the ranks that hold
    distinct rows, equal the unsharded step's (the port's, on the same
    params and batches), and some routings are dropped; ranks holding
    the same rows drop the same."""
    arch, preset = TRAIN[case]
    want = TR.one_rank_drops(arch, reference["train"][arch]["params"])
    distinct = _distinct_rows(world, preset)
    for s, w in enumerate(want):
        drops = {r["rank"]: r[("train", case)]["steps"][s]["drops"]
                 for r in world}
        assert sum(drops[r["rank"]] for r in distinct) == w, (case, s, w)
        for r in world:
            if preset in ("ep", "infer-tp"):   # a data row's model ranks
                assert drops[r["rank"]] == drops[r["rank"] // 2 * 2]
            elif preset == "infer-tp2":        # every rank: the whole batch
                assert drops[r["rank"]] == w
    assert sum(want) > 0


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_and_decode_match_the_unsharded_reference(case, world,
                                                          reference):
    arch, preset = SERVE[case]
    ref = reference["serve"][arch]
    rows = [r[("serve", case)] for r in world]
    want_shapes = _rule_shapes(ref["cfg"], preset)
    for r in rows:
        assert r["cache_shapes"] == want_shapes, (r["coord"], want_shapes)
        assert r["after_shapes"] == want_shapes
        a, n = r["rows"]
        for s, (got, want) in enumerate(zip(r["logits"], ref["logits"])):
            np.testing.assert_allclose(got, want[a:a + n], atol=LOGITS_ATOL,
                                       rtol=0, err_msg=f"{case} step {s}")
        for got, want in zip(r["tokens"], ref["tokens"]):
            assert np.array_equal(got, want[a:a + n]), case
        for other in rows:                    # the same rows, the same bits
            if other["rows"] == r["rows"]:
                assert all(np.array_equal(x, y) for x, y in
                           zip(r["logits"], other["logits"])), case
    assert sorted({r["rows"] for r in rows}) == [
        (i, rows[0]["rows"][1]) for i in range(0, SR.BATCH,
                                               rows[0]["rows"][1])]


@pytest.mark.parametrize("case", list(SERVE))
def test_prefill_overflow_equals_the_unsharded_step(case, world, reference):
    """Under the engines' capacity bound every rank reports the whole
    batch's overflowed routings, the unsharded prefill's count, so every
    rank would retry together; some overflow."""
    arch, _ = SERVE[case]
    want = R.one_rank_overflow(arch, reference["serve"][arch]["params"])
    assert want > 0
    assert [r[("overflow", case)] for r in world] == [want] * N_RANKS


def _bits(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def test_all_to_all_round_trips_bit_for_bit(world):
    """Slice j of what a rank gets is what the rank at index j of the
    axis sent it, bit for bit (-0.0 and NaN too), and a second exchange
    returns every rank's own tensor."""
    groups = {}
    for r in world:
        for axis, i, n, sent, once, twice in r["all_to_all"]:
            assert twice.dtype == sent.dtype == once.dtype
            assert torch.equal(_bits(twice), _bits(sent))
            other = {"data": r["coord"]["model"], "model": r["coord"]["data"],
                     None: 0}[axis]
            groups.setdefault((axis, sent.dtype, other), {})[i] = (sent, once)
    assert len(groups) == 3 * (2 + 2 + 1)
    for group in groups.values():
        for i, (_, once) in group.items():
            for j, (sent, _) in group.items():
                assert torch.equal(_bits(once[j]), _bits(sent[i]))


def test_a_donated_step_is_the_step_in_place(monkeypatch):
    """The mesh's step donates its params and moments (the reference's
    sharded step's ``donate_argnums=(0, 1)``): it returns the very
    tensors it was given (on a one-rank mesh here), and its update,
    ``adamw_update(donate=True)`` cut into pieces of DONATED_PIECE
    entries, holds bit for bit the undonated update's values.  The
    one-rank step writes nothing it was given."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.training import optim
    from repro_torch.tree import tree_leaves, tree_map
    monkeypatch.setattr(optim, "DONATED_PIECE", 1000)
    cfg = TR.serving_cfg("qwen3-moe-30b-a3b")
    params = T.init_params(cfg, seed=0, device="cpu", max_seq=64)
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen)
                     .to(t.dtype), params)
    want = optim.adamw_update(params, grads,
                              optim.adamw_init(params, TR.OPT), TR.OPT)
    mine = tree_map(torch.clone, params)
    state = optim.adamw_init(mine, TR.OPT)
    got = optim.adamw_update(mine, grads, state, TR.OPT, donate=True)
    assert all(a is b for a, b in zip(tree_leaves(got[0]),
                                      tree_leaves(mine)))
    assert all(a is b for a, b in zip(tree_leaves(got[1]["nu"]),
                                      tree_leaves(state["nu"])))
    for k in (0, 1):
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want[k])):
            assert torch.equal(a, b)
    batch = {"tokens": torch.as_tensor(TR.batches(cfg)[0])}
    mine = tree_map(torch.clone, params)
    state = optim.adamw_init(mine, TR.OPT)
    out = make_train_step(cfg, TR.OPT, mesh=make_mesh(1, 1))(
        mine, state, batch)
    assert all(a is b for a, b in zip(tree_leaves(out[0]),
                                      tree_leaves(mine)))
    assert all(a is b for a, b in zip(tree_leaves(out[1]["mu"]),
                                      tree_leaves(state["mu"])))
    kept = tree_map(torch.clone, params)
    make_train_step(cfg, TR.OPT)(params, optim.adamw_init(params, TR.OPT),
                                 batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(kept)))