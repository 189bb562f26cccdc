"""The reference runs and the checks shared by the family mesh tests
(tests/test_torch_mesh_hybrid.py, tests/test_torch_mesh_side.py,
tests/test_torch_mesh_xlstm.py): each
4-rank gloo world (tests/mesh_family_ranks.py, no JAX) is held against
the reference's UNSHARDED ``make_train_step``, ``prefill`` and
``decode_step`` on the same params and inputs.

Tolerances.  Training: tests/test_torch_mesh_training.py's rules for
the metrics, the params and the unembedding weight (its docstring says
why), and for the moments its atol and rtol plus MOMENT_SCALE[step] of
the leaf's largest entry.  fp32 sums over the ranks in another order err
in proportion to the terms summed (tests/test_torch_hybrid_training.py
allows the gradients GRAD_SCALE_ATOL, 2e-5 of the largest entry), and
the Mamba2 leaves' moments are large beside most of their entries
(zamba2's ``conv_b``, ``A_log``): after the first step the moments erred
up to 1.8e-5 of the largest entry (seen); after the second up to 2.0e-4,
on the (4, 1) mesh too, where no weight is cut: the second step's
gradients come from params that the first step's near-zero-gradient
entries moved up to 2 lr apart (tests/test_torch_mesh_training.py's
docstring), so 5e-5 and 5e-4.  A wrong moment (a partial sum left
unsummed, a head's share read from another's) is off by O(1) of the
largest entry.  Serving: logits within LOGITS_ATOL (1e-4) of the
reference's, the greedy tokens identical, as
tests/test_torch_seq_decode.py."""
import jax
import jax.numpy as jnp
import numpy as np

import mesh_family_ranks as R
from repro.launch import sharding as JSH
from repro.launch import steps as JS
from repro.models import pspec as JPS
from repro.models import transformer as JT
from repro.training import optim as JO
from repro_torch.config import ShapeSpec
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.launch.mesh import spawn
from test_sharding import _abstract_mesh
from test_torch_mesh_training import (METRIC_ATOL, METRICS, MU_TOL, NU_TOL,
                                      UNEMBED, _close_params, _flat)
from test_torch_pspec import _reference_leaves, _xlstm_cache_shape
from test_torch_seq_decode import LOGITS_ATOL, _np, _positions

N_RANKS = 4
MOMENT_SCALE = (5e-5, 5e-4)


def reference(archs: tuple) -> dict:
    """Per arch: the reference's params (numpy); after each step of its
    unsharded ``make_train_step`` its metrics, params and moments; the
    logits and greedy tokens of its unsharded prefill (the k/v leaves
    laid out for MAX_SEQ positions past the patches) and decode
    steps."""
    opt = JO.OptimConfig(**{k: getattr(R.OPT, k) for k in (
        "lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
        "weight_decay", "grad_clip", "moment_dtype")})
    out = {}
    for arch in archs:
        cfg = R.config(arch)
        params = jax.jit(lambda k: JT.init_params(k, cfg, max_seq=R.SEQ))(
            jax.random.PRNGKey(0))
        np_params = _np(params)
        p, state = params, JO.adamw_init(params, opt)
        step = jax.jit(JS.make_train_step(cfg, opt))
        rows = []
        for b in R.batches(cfg):
            p, state, m = step(p, state, {k: jnp.asarray(v)
                                          for k, v in b.items()})
            rows.append(dict(metrics={k: float(v) for k, v in m.items()},
                             params=_flat(jax.device_get(p)),
                             mu=_flat(jax.device_get(state["mu"])),
                             nu=_flat(jax.device_get(state["nu"]))))
        batch = {k: jnp.asarray(v) for k, v in R.prompts(cfg).items()}
        logits, cache = jax.jit(lambda p, b: JT.prefill(p, cfg, b))(
            params, batch)
        S = R.MAX_SEQ + R.patches(cfg)
        cache = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(_positions(np.asarray(a), S))
            if JSH._path_names(path)[-1] in ("k", "v") else a, cache)
        dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
        logs, tokens = [np.asarray(logits[:, 0])], []
        for t in range(R.DECODE_STEPS):
            nxt = np.asarray(jnp.argmax(logits[:, 0], -1)).astype(np.int32)
            tokens.append(nxt)
            logits, cache = dec(params, cache, jnp.asarray(nxt[:, None]),
                                jnp.int32(R.patches(cfg) + R.PROMPT + t))
            logs.append(np.asarray(logits[:, 0]))
        out[arch] = dict(params=np_params, steps=rows, logits=logs,
                         tokens=tokens, cfg=cfg)
    return out


def world(reference: dict, archs: tuple) -> list:
    return spawn(R.run_world, N_RANKS, archs,
                 {a: reference[a]["params"] for a in archs}, device="cpu",
                 threads=1, timeout_s=600)


def _close_moments(got: dict, want: dict, tol, what: str, ulps: int,
                   step: int):
    atol, rtol = tol
    assert set(got) == set(want), what
    for path, w in want.items():
        big = float(np.abs(w).max())
        a = (ulps * 2.0 ** -8 * big if path in UNEMBED
             else atol + MOMENT_SCALE[step] * big)
        np.testing.assert_allclose(got[path], w, atol=a, rtol=rtol,
                                   err_msg=f"{what} {path}")


def check_train(world: list, reference: dict, arch: str, case: str):
    """Each step's metrics (the same on every rank), params and moments
    against the reference's unsharded step's."""
    ref = reference[arch]["steps"]
    rows = [r[("train", arch, case)] for r in world]
    for s, want in enumerate(ref):
        got = [r["steps"][s] for r in rows]
        for k in METRICS:
            w = want["metrics"][k]
            for g in got:
                assert g["metrics"][k] == got[0]["metrics"][k], (k, s)
            np.testing.assert_allclose(
                got[0]["metrics"][k], w, atol=METRIC_ATOL * max(1.0, abs(w)),
                err_msg=f"{arch} {case} step {s} {k}")
        r0 = got[0]
        _close_params(r0["params"], ref, s + 1, f"{arch} {case} step {s}")
        _close_moments(r0["mu"], want["mu"], MU_TOL,
                       f"{arch} {case} step {s} mu", 1, s)
        _close_moments(r0["nu"], want["nu"], NU_TOL,
                       f"{arch} {case} step {s} nu", 2, s)


def check_slices(world: list, arch: str, case: str, shape, preset: str):
    """Each rank's params and moments have the rule's shapes
    (``param_plan`` on the whole shapes, its packed Mamba2 cut
    included)."""
    want = R.local_shapes(arch, preset, shape)
    for r in world:
        got = r[("train", arch, case)]
        assert got["shapes"] == want and got["moment_shapes"] == want


def _counted(arch: str, case: str, shape, preset: str, kind: str,
             seq: int) -> dict:
    """The dry-run's step of the case (``dryrun_one`` on a
    ``CountingMesh`` of ``shape``, rank 0, gloo's path on CPU tensors):
    its collectives by axis and kind, with their result bytes."""
    cfg = R.config(arch)
    res = dryrun_one(arch, ShapeSpec(f"{case}_{kind}", seq, R.BATCH, kind),
                     mesh=shape, sharding=preset, backend="gloo-cpu",
                     cfg=cfg, verbose=False)
    return {a: {k: (v["count"], v["bytes"]) for k, v in kinds.items()
                if k != "link_bytes" and v["count"]}
            for a, kinds in res["collectives_by_axis"].items()}


def check_counting(world: list, arch: str, case: str, shape, preset: str):
    """The dry-run's train, prefill and decode steps issue each kind of
    collective on each axis as often, with as many result bytes, as
    every step of the world did on every rank (the Mamba2 norm's
    all-reduces among them)."""
    cfg = R.config(arch)
    P = R.patches(cfg)
    train = _counted(arch, case, shape, preset, "train", R.SEQ + P)
    prefill = _counted(arch, case, shape, preset, "prefill", R.PROMPT + P)
    decode = _counted(arch, case, shape, preset, "decode", R.MAX_SEQ + P)
    for r in world:
        for step in r[("train", arch, case)]["steps"]:
            assert step["kinds"] == train, (r["rank"], step["kinds"], train)
        kinds = r[("serve", arch, case)]["kinds"]
        assert kinds[0] == prefill, (r["rank"], kinds[0], prefill)
        for k in kinds[1:]:
            assert k == decode, (r["rank"], k, decode)


def rule_cache_shapes(cfg, shape, preset: str) -> dict:
    """Each cache leaf's shape on a rank under the reference's rule on a
    ``shape`` ``AbstractMesh`` (every rank's is the same), but the
    Mamba2 conv window's channels and the xLSTM state: the port's
    departures (the rank's heads' x channels, B and C whole; the xLSTM
    state's rows and heads: ``test_torch_pspec._xlstm_cache_shape``;
    ``sharding._cache_cuts``)."""
    jm = _abstract_mesh(shape, ("data", "model"))
    S = R.MAX_SEQ + R.patches(cfg)
    cache = jax.eval_shape(lambda: JT.init_cache(cfg, R.BATCH, S))
    lm = JSH.SHARDING_PRESETS[preset]
    out = {}
    with JPS.mesh_rules(jm, lm):
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim \
            if cfg.ssm is not None else 0
        for path, (jpath, leaf) in _reference_leaves(cache).items():
            spec = JPS.pspec_for(leaf.shape, JSH.cache_logical_axes(
                cfg, jpath, leaf))
            got = [s // int(np.prod([jm.shape[a] for a in (
                e if isinstance(e, tuple) else (e,))]))
                if e is not None else s for s, e in zip(leaf.shape, spec)]
            if path[0] in ("mlstm_units", "slstm_units"):
                got = _xlstm_cache_shape(cfg, path, leaf.shape, jm)
            elif path[-1] == "conv":
                n = JPS.shard_count("model", nh)
                gn = cfg.ssm.n_groups * cfg.ssm.d_state
                got[-1] = (leaf.shape[-1] - 2 * gn) // n + 2 * gn
            out["/".join(path)] = tuple(got)
    return out


def check_serve(world: list, reference: dict, arch: str, case: str, shape,
                preset: str):
    """The prefill's and each decode step's logits within LOGITS_ATOL of
    the reference's for the rank's rows, the greedy tokens identical,
    ranks holding the same rows equal to the bit, every rank's rows
    covering the batch, and each cache leaf the rule's slice."""
    ref = reference[arch]
    rows = [r[("serve", arch, case)] for r in world]
    want_shapes = rule_cache_shapes(ref["cfg"], shape, preset)
    for r in rows:
        assert r["cache_shapes"] == want_shapes, (r["coord"], want_shapes)
        assert r["after_shapes"] == want_shapes
        a, n = r["rows"]
        for s, (got, want) in enumerate(zip(r["logits"], ref["logits"])):
            np.testing.assert_allclose(got, want[a:a + n], atol=LOGITS_ATOL,
                                       rtol=0, err_msg=f"{case} step {s}")
        for got, want in zip(r["tokens"], ref["tokens"]):
            assert np.array_equal(got, want[a:a + n]), case
        for other in rows:
            if other["rows"] == r["rows"]:
                assert all(np.array_equal(x, y) for x, y in
                           zip(r["logits"], other["logits"])), case
    assert sorted({r["rows"] for r in rows}) == [
        (i, rows[0]["rows"][1]) for i in range(0, R.BATCH,
                                               rows[0]["rows"][1])]
