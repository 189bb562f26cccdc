"""What each rank of the port's mesh-training test runs
(tests/test_torch_mesh_training.py, a 4-rank gloo world on the CPU).  It
imports the port and numpy and nothing of JAX, so a rank spawned with
``repro_torch.launch.mesh.spawn`` never loads it.

The configs are the sharded-serving tests' (tests/sharded_ranks.py,
the twins of tests/test_sharding.py's ``_serving_cfg``): reduced fp32
configs whose KV heads divide a 2- and a 4-way model axis."""
import os

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.training import optim
from repro_torch.training.loop import TrainState, train
from repro_torch.tree import tree_leaves_with_path
from sharded_ranks import serving_cfg

STEPS, BATCH, SEQ = 2, 4, 32
OPT = optim.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
# (name, arch, (data, model), preset)
CASES = (("dense_baseline_2x2", "smollm-360m", (2, 2), "baseline"),
         ("moe_baseline_2x2", "qwen3-moe-30b-a3b", (2, 2), "baseline"),
         ("mla_baseline_2x2", "deepseek-v3-671b", (2, 2), "baseline"),
         ("dense_baseline_4x1", "smollm-360m", (4, 1), "baseline"),
         ("dense_baseline_1x4", "smollm-360m", (1, 4), "baseline"),
         ("dense_dp_2x2", "smollm-360m", (2, 2), "dp"))
CHECKPOINT_CASE = "dense_baseline_2x2"
LOOP_CASE = "dense_dp_2x2"
# tests/test_torch_mesh_pod.py: (pod, data, model) meshes, FSDP and the
# batch over ("pod", "data") under baseline (over "pod" alone on
# (2, 1, 2)), and dp's batch over every axis with FSDP over "data"
POD_CASES = (("dense_baseline_2x1x2", "smollm-360m", (2, 1, 2), "baseline"),
             ("moe_baseline_2x1x2", "qwen3-moe-30b-a3b", (2, 1, 2),
              "baseline"),
             ("dense_baseline_2x2x1", "smollm-360m", (2, 2, 1), "baseline"),
             ("moe_baseline_2x2x1", "qwen3-moe-30b-a3b", (2, 2, 1),
              "baseline"),
             ("dense_dp_2x2x1", "smollm-360m", (2, 2, 1), "dp"),
             ("moe_dp_2x2x1", "qwen3-moe-30b-a3b", (2, 2, 1), "dp"))


def batches(cfg) -> list:
    """The global batches of the steps: seeded numpy tokens."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def flat(tree) -> dict:
    """"a/b/c" -> a numpy copy of the leaf (the mesh's step updates its
    params and moments in place)."""
    return {"/".join(p): t.detach().clone().numpy()
            for p, t in tree_leaves_with_path(tree)}


def one_case(mesh, arch: str, shape, preset: str, np_tree) -> dict:
    """Two steps of ``make_train_step(mesh=...)`` on this rank's slices
    and rows: per step the metrics, this rank's dropped routings, the
    collectives by axis, and (every rank gathering, rank 0 keeping them)
    the whole params and moments; the slices' shapes.  Returns (that,
    the rank's params after the last step)."""
    cfg = serving_cfg(arch)
    lmap = SH.train_map(preset)
    full = params_from_numpy(np_tree, cfg, device="cpu")
    params = SH.shard_params(cfg, full, mesh, lmap)
    shapes = {k: v.shape for k, v in flat(params).items()}
    state = optim.adamw_init(params, OPT)
    step = make_train_step(cfg, OPT, mesh=mesh, logical_map=lmap)
    steps = []
    for toks in batches(cfg):
        rows = SH.shard_batch({"tokens": toks}, mesh, lmap)
        mesh.reset_counts()
        with M.drop_counts() as drops:
            params, state, m = step(params, state, {
                "tokens": torch.as_tensor(rows["tokens"])})
        row = dict(metrics={k: float(v) for k, v in m.items()},
                   drops=sum(int(v) for v in drops.values()),
                   collectives=dict(mesh.counts),
                   kinds=kinds_of(mesh))
        whole = {k: flat(SH.unshard_params(cfg, state[k] if k != "params"
                                           else params, mesh, lmap))
                 for k in ("params", "mu", "nu")}
        if mesh.rank == 0:
            row.update(whole)
        steps.append(row)
    return dict(steps=steps, shapes=shapes, coord=dict(mesh.coord),
                moment_shapes={k: v.shape for k, v in flat(state["mu"])
                               .items()}), params


def kinds_of(mesh) -> dict:
    """The mesh's collectives since its counts were reset, by axis and
    kind ({axis: {kind: (count, result bytes)}}, the kinds issued)."""
    return {a: {k: (v["count"], v["bytes"]) for k, v in kinds.items()
                if v["count"]}
            for a, kinds in mesh.by_axis.items()}


def combine_cases(mesh) -> list:
    """``Mesh.combine`` over the world on buffers each element of which
    one rank fills (rank r the elements i with i % size == r), -0.0 and
    NaN among them: bf16 and int8 of even and odd lengths (the lanes
    summed as int32 words, or widened), fp32.  Returns (sent, got)."""
    out = []
    for dtype, n in ((torch.bfloat16, 10), (torch.bfloat16, 7),
                     (torch.int8, 12), (torch.int8, 5), (torch.float32, 6)):
        g = torch.Generator().manual_seed(n)
        full = (torch.randn(n, generator=g) * 50).to(dtype)
        if dtype.is_floating_point:
            full[0], full[-1] = -0.0, float("nan")
        mine = torch.zeros_like(full)
        own = torch.arange(n) % mesh.size == mesh.rank
        mine[own] = full[own]
        out.append((full, mesh.combine(mine.clone())))
    return out


def run_world(mesh, trees: dict, tmp: str) -> dict:
    """Every case of the CPU test in one world (a (D, M) mesh built for
    each), then the dp case once more through ``training.loop.train``,
    and the smollm baseline case's params written unsharded to a
    checkpoint under ``tmp`` (rank 0 writes, as ``launch/train.py``
    does)."""
    torch.manual_seed(0)
    out = {"rank": mesh.rank, "combine": combine_cases(mesh)}
    for name, arch, shape, preset in CASES:
        m = make_mesh(*shape)
        out[name], params = one_case(m, arch, shape, preset, trees[arch])
        if name == CHECKPOINT_CASE:
            from repro_torch.checkpoint import save_checkpoint
            cfg = serving_cfg(arch)
            whole = SH.unshard_params(cfg, params, m, SH.train_map(preset))
            path = os.path.join(tmp, "mesh_trained.ckpt")
            if m.rank == 0:
                save_checkpoint(path, whole, {"arch": cfg.name})
            m.barrier()
            out["checkpoint"] = path
        if name == LOOP_CASE:
            cfg = serving_cfg(arch)
            lmap = SH.train_map(preset)
            full = params_from_numpy(trees[arch], cfg, device="cpu")
            local = SH.shard_params(cfg, full, m, lmap)
            st = train(cfg, TrainState(local, optim.adamw_init(local, OPT)),
                       iter({"tokens": t} for t in batches(cfg)), OPT,
                       steps=STEPS, log_every=1, mesh=m, logical_map=lmap)
            out["loop"] = [r["loss"] for r in st.history]
    return out


def run_pod_world(mesh, trees: dict) -> dict:
    """Every case of POD_CASES in one world (a (pod, data, model) mesh
    built for each)."""
    torch.manual_seed(0)
    out = {"rank": mesh.rank}
    for name, arch, shape, preset in POD_CASES:
        out[name], _ = one_case(make_mesh(*shape), arch, shape, preset,
                                trees[arch])
    return out


def one_rank_drops(arch: str, np_tree) -> list:
    """The dropped routings of each step of the unsharded step (the
    port's, on the same params and batches)."""
    cfg = serving_cfg(arch)
    params = params_from_numpy(np_tree, cfg, device="cpu")
    state = optim.adamw_init(params, OPT)
    step = make_train_step(cfg, OPT)
    out = []
    for toks in batches(cfg):
        with M.drop_counts() as drops:
            params, state, _ = step(params, state,
                                    {"tokens": torch.as_tensor(toks)})
        out.append(sum(int(v) for v in drops.values()))
    return out


def local_shapes(arch: str, preset: str, shape) -> dict:
    """The rule's slice shapes (``sharding.param_plan`` on the whole
    shapes) of every leaf on a ``shape`` mesh."""
    from repro_torch.models.pspec import MeshShape
    cfg = serving_cfg(arch)
    whole = T.param_shapes(cfg)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    plan = SH.param_plan(cfg, whole, MeshShape(names, shape),
                         SH.train_map(preset))
    return {"/".join(p): SH.local_shape(t.shape, *plan[p])
            for p, t in tree_leaves_with_path(whole)}
