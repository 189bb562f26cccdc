"""The port's mesh training on the CPU: ``make_train_step(mesh=...)`` on
(data, model) meshes of a 4-rank gloo world
(``repro_torch.launch.mesh.spawn``; the ranks run
tests/mesh_train_ranks.py, which imports no JAX), two steps of a seeded
4 x 32 batch in fp32 under the reference's ``baseline`` preset on
(2, 2) for smollm (8/4 heads of 32), qwen3-moe (4 KV heads) and
deepseek-v3 reduced (MLA, MoE and MTP), on (4, 1) and (1, 4) for smollm,
and under ``dp`` on (2, 2) for smollm.

Each run is held against the reference's UNSHARDED ``make_train_step``
on the same params and batches: the reference's sharded step needs a
mesh of ``Auto`` axes on jax 0.9.0 (ROADMAP Queue 3 item 8); on one,
its sharded and unsharded steps agree within 2.3e-7 after a step.
Held after each step: the metrics, every param and both AdamW moments
of the whole tree (the ranks' slices gathered exactly).

Tolerances, stated here: metrics (loss, aux_loss, mtp_loss,
perplexity, grad_norm, lr) atol 1e-5, relative above 1.  The first
moment mu (0.1 x the clipped gradient after a step) atol 1e-7 + rtol
1e-4 and the second nu (0.05 x its square) atol 1e-10 + rtol 2e-4 (mu
reaches ~5e-4, nu ~1e-6; the second step's gradients come from params
that the first step's near-zero-gradient entries, below, moved apart),
except on the unembedding weight (the tied ``embed`` or ``lm_head``),
which gets one bf16 ulp of its largest entry (two for nu, a square):
both sides round that weight to bf16 in the forward
(``layers.unembed``), so its gradient is rounded to bf16 on the way
back, and a sum in another order can move a rounding by one ulp.
Params atol 1e-5 where the reference's gradient scale sqrt(vhat) is at
least SENSITIVE (1e-5), and 2 x lr x steps elsewhere (an entry below it
at one step stays so): AdamW's step mhat / (sqrt(vhat) + eps) is ~1
whatever the gradient's size, so an entry whose gradient sits near zero
turns a last-bit difference of the gradient into a step difference (a
few entries a leaf, up to 1.3e-4 here); a wrong update moves entries by
~1e-3 where the gradient is not small.  The unembedding weight's firm
entries get 1e-4 (a tenth of lr) from the second step: its gradients
carry a bf16 ulp each (above), and where the two steps' gradients
nearly cancel in mhat the step's relative error grows (5.3e-5 seen).

MoE: the one group of a step's 128 tokens spans both data ranks, so
the ranks' slot positions continue each other's; each step's dropped
routings, summed over the data ranks, equal the port's unsharded
step's, and some are dropped.  A checkpoint written on the mesh (the
params gathered whole) loads into the port's one-rank engine, which
emits the tokens the reference's trained params give it, and into the
reference's ``load_checkpoint``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mesh_train_ranks as R  # noqa: E402
from repro.checkpoint import load_checkpoint as j_load  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.training import optim as JO  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import pspec as PS  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.batching import Request  # noqa: E402
from repro_torch.serving.engine import ContinuousEngine  # noqa: E402
from test_sharding import _params_for, _serving_cfg  # noqa: E402

N_RANKS = 4
ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b", "deepseek-v3-671b")
CASES = {name: (arch, shape, preset)
         for name, arch, shape, preset in R.CASES}
METRICS = ("loss", "aux_loss", "mtp_loss", "perplexity", "grad_norm", "lr")
METRIC_ATOL = 1e-5
MU_TOL, NU_TOL = (1e-7, 1e-4), (1e-10, 2e-4)
PARAM_ATOL = 1e-5
UNEMBED_PARAM_ATOL = 1e-4
SENSITIVE = 1e-5
UNEMBED = ("embed", "lm_head")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


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
        out[arch] = dict(params=np_params, steps=rows,
                         final=jax.device_get(params))
    return out


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    trees = {arch: reference[arch]["params"] for arch in ARCHS}
    return spawn(R.run_world, N_RANKS, trees, tmp, device="cpu", threads=1,
                 timeout_s=300)


def _close(got: dict, want: dict, atol, rtol, what, unembed_ulps=None):
    assert set(got) == set(want), what
    for path, w in want.items():
        a = atol
        if unembed_ulps is not None and path in UNEMBED:
            a = unembed_ulps * 2.0 ** -8 * float(np.abs(w).max())
        np.testing.assert_allclose(got[path], w, atol=a, rtol=rtol,
                                   err_msg=f"{what} {path}")


def _close_params(got: dict, ref: list, t: int, what: str):
    """Params after step ``t`` of the reference's steps ``ref`` (see the
    module docstring): an entry is firm where its gradient scale was at
    least SENSITIVE at every step so far."""
    want = ref[t - 1]
    assert set(got) == set(want["params"]), what
    lr = R.OPT.lr
    for path, w in want["params"].items():
        firm = np.all([np.sqrt(r["nu"][path] / (1 - R.OPT.b2 ** (i + 1)))
                       >= SENSITIVE for i, r in enumerate(ref[:t])], axis=0)
        err = np.abs(got[path] - w)
        atol = UNEMBED_PARAM_ATOL if path in UNEMBED else PARAM_ATOL
        assert err[firm].max(initial=0) <= atol, \
            (what, path, float(err[firm].max()))
        assert err.max() <= 2 * lr * t, (what, path, float(err.max()))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_the_unsharded_reference(case, world, reference):
    arch, shape, preset = CASES[case]
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
    """Each rank's params and moments have the shapes of the rule
    (``param_plan`` on the whole shapes) at its coordinates, and the
    collectives went over the axes the mesh has."""
    arch, shape, preset = CASES[case]
    want = R.local_shapes(arch, preset, shape)
    for r in world:
        got = r[case]
        assert got["shapes"] == want and got["moment_shapes"] == want
        assert got["coord"] == {"data": r["rank"] // shape[1],
                                "model": r["rank"] % shape[1]}
        for step in got["steps"]:
            c = step["collectives"]
            assert (c["data"] > 0) == (shape[0] > 1), c
            assert (c["model"] > 0) == (shape[1] > 1), c


@pytest.mark.parametrize("case", list(CASES))
def test_counting_mesh_predicts_the_world_collectives(case, world):
    """The dry-run's step (``launch.dryrun``: the same step built on the
    meta device on a ``CountingMesh``, rank 0, gloo on CPU tensors)
    issues, axis by axis, the collectives each step of the world issued
    on every rank, and charges one flash launch per layer and remat
    recompute, as the card counts them."""
    from repro_torch.config import ShapeSpec
    from repro_torch.launch.dryrun import dryrun_one
    arch, shape, preset = CASES[case]
    cfg = R.serving_cfg(arch)
    res = dryrun_one(arch, ShapeSpec(case, R.SEQ, R.BATCH, "train"),
                     mesh=shape, sharding=preset, backend="gloo", cfg=cfg,
                     verbose=False)
    got = {a: sum(v["count"] for k, v in kinds.items() if k != "link_bytes")
           for a, kinds in res["collectives_by_axis"].items()}
    for r in world:
        for step in r[case]["steps"]:
            assert step["collectives"] == got, (r["rank"], got)
    # two a layer (remat recomputes each block), one for the MTP block
    assert res["kernels"] == {"flash_attention": 2 * cfg.n_layers
                              + int(cfg.use_mtp)}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v3-671b"])
def test_moe_drops_equal_the_unsharded_step(arch, world, reference):
    """The one group spans both data ranks: the drops summed over the
    data ranks (model index 0) equal the unsharded step's, each step,
    and some routings are dropped; the model ranks of a data row agree."""
    case = next(n for n, (a, _, _) in CASES.items() if a == arch)
    want = R.one_rank_drops(arch, reference[arch]["params"])
    rows = {r["rank"]: r[case] for r in world}
    for s, w in enumerate(want):
        assert rows[0]["steps"][s]["drops"] == rows[1]["steps"][s]["drops"]
        assert rows[2]["steps"][s]["drops"] == rows[3]["steps"][s]["drops"]
        got = rows[0]["steps"][s]["drops"] + rows[2]["steps"][s]["drops"]
        assert got == w, (s, got, w)
    assert sum(want) > 0
    assert rows[2]["steps"][-1]["drops"] > 0     # the later rows drop


def test_combine_is_bit_exact(world):
    """``Mesh.combine`` returns every rank's contribution bit for bit,
    -0.0 and NaN too, whether the lanes are summed as int32 words, as
    themselves or widened."""
    for r in world:
        for sent, got in r["combine"]:
            assert got.dtype == sent.dtype
            bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
                sent.element_size()]
            assert torch.equal(got.view(bits), sent.view(bits))


def test_training_loop_on_a_mesh(world, reference):
    """``training.loop.train(mesh=...)``: the same losses as the step."""
    arch = CASES[R.LOOP_CASE][0]
    want = [s["metrics"]["loss"] for s in reference[arch]["steps"]]
    for r in world:
        np.testing.assert_allclose(r["loop"], want, atol=METRIC_ATOL)


def test_checkpoint_from_the_mesh_loads_into_one_rank(world, reference):
    """The unsharded checkpoint the mesh wrote: the reference's trained
    params within PARAM_ATOL through the port's and the reference's
    loaders, and the port's one-rank engine emits the tokens it emits
    on the reference's trained params."""
    arch = CASES[R.CHECKPOINT_CASE][0]
    cfg = R.serving_cfg(arch)
    path = world[0]["checkpoint"]
    want = reference[arch]["final"]
    template = T.init_params(cfg, seed=1, device="cpu", max_seq=64)
    got, meta = load_checkpoint(path, template)
    assert meta["arch"] == cfg.name
    ref = reference[arch]["steps"]
    _close_params(R.flat(got), ref, len(ref), "port load")
    jgot, _ = j_load(path, want)
    _close_params(_flat(jgot), ref, len(ref), "reference load")

    def tokens(params):
        eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                               page_size=8)
        rng = np.random.default_rng(9)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=n)
                        .astype(np.int32), max_new=8, rid=i)
                for i, n in enumerate((5, 13))]
        res = eng.run(reqs)
        return [res[i].tokens for i in range(2)]
    mine = tokens(got)
    theirs = tokens(params_from_numpy(want, cfg, device="cpu"))
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,preset,what", [
    ("xlstm-1.3b", "ep", "family"),
    ("qwen2-vl-2b", "ep", "family"),
    ("zamba2-7b", "ep", "family"),
    ("zamba2-7b", "baseline", "family"),
    ("whisper-tiny", "baseline", "family")])
def test_what_the_port_does_not_train_on_a_mesh_raises(arch, preset, what):
    """Every family builds its mesh step under every preset, the ssm
    family (xLSTM) since its blocks are cut on whole heads
    (tests/test_torch_mesh_xlstm.py, tests/test_torch_mesh_hybrid.py and
    tests/test_torch_mesh_side.py run them); a family outside
    MESH_TRAIN_FAMILIES would raise, naming the port's mesh families."""
    from repro_torch.config import get_reduced_config
    from repro_torch.training import optim
    cfg = get_reduced_config(arch)
    mesh = PS.MeshShape(("data", "model"), (2, 2))
    lmap = SH.SHARDING_PRESETS[preset] or PS.DEFAULT_LOGICAL_MAP

    def build():
        return make_train_step(cfg, optim.OptimConfig(), mesh=mesh,
                               logical_map=lmap)
    if cfg.family not in SH.MESH_TRAIN_FAMILIES:
        with pytest.raises(NotImplementedError, match="mesh families"):
            build()
        with pytest.raises(NotImplementedError, match="mesh families"):
            SH.check_serve(cfg, lmap)
    else:
        assert callable(build())
        assert SH.check_train(cfg, lmap) == SH.check_serve(cfg, lmap) == lmap


def test_launcher_dry_run_raises():
    """``--dry-run`` builds and counts the step on the meta device (it
    raised until the dry-run was ported): xlstm-1.3b's too since its
    blocks are cut on whole heads (it launches no kernel), and on a
    multi-pod mesh (it raised until the mesh had a "pod" axis)."""
    from repro_torch.launch import dryrun as D
    res = LT.main(["--reduced", "--dry-run", "--device", "cpu"])
    assert res["mesh"] == "16x16" and res["kernels"]["flash_attention"] > 0
    res = LT.main(["--arch", "xlstm-1.3b", "--reduced", "--dry-run",
                   "--shape", "train_4k"])
    assert not res.get("skipped") and res["kernels"] == {}
    res = LT.main(["--arch", "zamba2-7b", "--reduced", "--dry-run"])
    assert res["kernels"]["ssm_chunk_scan"] > 0
    res = D.main(["--arch", "smollm-360m", "--shape", "train_4k",
                  "--multi-pod"])
    assert res["mesh"] == "2x16x16"
