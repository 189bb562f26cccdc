"""The mesh's "pod" axis on the CPU: ``make_train_step(mesh=...)`` on
(pod, data, model) meshes of a 4-rank gloo world
(``repro_torch.launch.mesh.spawn``; the ranks run
tests/mesh_train_ranks.py's ``run_pod_world``, which imports no JAX),
two steps of a seeded 4 x 32 batch in fp32, for reduced smollm-360m and
qwen3-moe-30b-a3b (4 KV heads, 4 experts): under ``baseline`` on
(2, 1, 2), where the reference's default map cuts FSDP and the batch
over ("pod", "data"), "pod" alone here, and on (2, 2, 1), four ways
over both; and under ``dp`` on (2, 2, 1) (the batch over every axis,
FSDP over "data").

Held against the reference's UNSHARDED ``make_train_step`` on the same
params and batches, under tests/test_torch_mesh_training.py's stated
tolerances: the metrics, every param and both AdamW moments of the
whole tree after each step; each rank's slices have the rule's shapes
(``param_plan`` on a (pod, data, model) ``MeshShape``) at its
coordinates (rank r at (r // (D M), (r // M) % D, r % M)); the dry-run's
``CountingMesh`` of the same shape issues each step's collectives kind
by kind, set of axes by set of axes, with their bytes; the MoE's
dropped routings summed over the ranks of distinct rows equal the
unsharded step's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mesh_train_ranks as R  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from test_sharding import _params_for, _serving_cfg  # noqa: E402
from test_torch_mesh_training import (METRIC_ATOL, METRICS,  # noqa: E402
                                      MU_TOL, NU_TOL, _close, _close_params,
                                      _flat)

N_RANKS = 4
ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b")
CASES = {name: (arch, shape, preset)
         for name, arch, shape, preset in R.POD_CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's params (numpy), and after each step of
    its unsharded ``make_train_step`` its metrics, params and moments."""
    opt = JO.OptimConfig(**{k: getattr(R.OPT, k) for k in (
        "lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
        "weight_decay", "grad_clip", "moment_dtype")})
    out = {}
    for arch in ARCHS:
        cfg = _serving_cfg(arch)
        params = _params_for(cfg)
        state = JO.adamw_init(params, opt)
        step = jax.jit(JS.make_train_step(cfg, opt))
        rows = []
        np_params = jax.device_get(params)
        for toks in R.batches(R.serving_cfg(arch)):
            params, state, m = step(params, state,
                                    {"tokens": jnp.asarray(toks)})
            rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                             params=_flat(jax.device_get(params)),
                             mu=_flat(jax.device_get(state["mu"])),
                             nu=_flat(jax.device_get(state["nu"]))))
        out[arch] = dict(params=np_params, steps=rows)
    return out


@pytest.fixture(scope="module")
def world(reference):
    trees = {arch: reference[arch]["params"] for arch in ARCHS}
    return spawn(R.run_pod_world, N_RANKS, trees, device="cpu", threads=1,
                 timeout_s=300)


@pytest.mark.parametrize("case", list(CASES))
def test_pod_steps_match_the_unsharded_reference(case, world, reference):
    arch, _, _ = CASES[case]
    ref = reference[arch]["steps"]
    rows = [r[case] for r in world]
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


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_the_rule_slices(case, world):
    """Each rank's params and moments have the rule's shapes at its
    (pod, data, model) coordinates, and the collectives went over the
    sets of axes the preset cuts: under ``baseline`` FSDP and the batch
    over ("pod", "data"), keyed "pod" on (2, 1, 2) (its "data" is one
    rank) and "pod,data" on (2, 2, 1), and nothing over "data" alone;
    under ``dp`` FSDP over "data" (an FSDP leaf's gradient
    reduce-scattered there, then summed over "pod"), the other leaves'
    over the batch's axes of more than one rank, ("pod", "data")."""
    arch, shape, preset = CASES[case]
    P, D, M = shape
    want = R.local_shapes(arch, preset, shape)
    for r in world:
        got = r[case]
        assert got["shapes"] == want and got["moment_shapes"] == want
        k = r["rank"]
        assert got["coord"] == {"pod": k // (D * M), "data": k // M % D,
                                "model": k % M}
        for step in got["steps"]:
            c = step["collectives"]
            assert (c["model"] > 0) == (M > 1), c
            if preset == "baseline":
                fsdp, other = ("pod", "pod,data") if D == 1 else (
                    "pod,data", "pod")
                assert c[fsdp] > 0 and c[other] == c["data"] == 0, c
            else:               # dp: FSDP over "data", the batch over all
                assert c["data"] > 0 and c["pod"] > 0, c
                assert c["pod,data"] > 0, c


@pytest.mark.parametrize("case", list(CASES))
def test_counting_mesh_predicts_the_world_collectives(case, world):
    """The dry-run's step on a ``CountingMesh`` of the case's (pod,
    data, model) shape (rank 0, gloo on CPU tensors) issues each kind of
    collective on each set of axes as often, with as many result bytes,
    as every step of the world did on every rank."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    arch, shape, preset = CASES[case]
    res = dryrun_one(arch, ShapeSpec(case, R.SEQ, R.BATCH, "train"),
                     mesh=shape, sharding=preset, backend="gloo-cpu",
                     cfg=R.serving_cfg(arch), verbose=False)
    assert res["mesh"] == "x".join(map(str, shape))
    want = {a: {k: (v["count"], v["bytes"]) for k, v in kinds.items()
                if k != "link_bytes" and v["count"]}
            for a, kinds in res["collectives_by_axis"].items()}
    for r in world:
        for step in r[case]["steps"]:
            assert step["kinds"] == want, (r["rank"], step["kinds"], want)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("moe")])
def test_moe_drops_equal_the_unsharded_step(case, world, reference):
    """The ranks of distinct rows (model index 0; every rank under
    ``dp``) drop, summed, the unsharded step's routings, each step."""
    arch, shape, preset = CASES[case]
    want = R.one_rank_drops(arch, reference[arch]["params"])
    keep = [r for r in world if preset == "dp"
            or r[case]["coord"]["model"] == 0]
    for s, w in enumerate(want):
        assert sum(r[case]["steps"][s]["drops"] for r in keep) == w, (s, w)
    assert sum(want) > 0
