"""What each rank of the port's family mesh tests runs
(tests/test_torch_mesh_hybrid.py for zamba2, tests/test_torch_mesh_side.py
for whisper and qwen2-vl, tests/test_torch_mesh_xlstm.py for xlstm-1.3b;
a 4-rank gloo world on the CPU).  It imports the port and numpy and
nothing of JAX, so a rank spawned with ``repro_torch.launch.mesh.spawn``
never loads it.

Each case is one reduced fp32 config on a (data, model) mesh under one
of the reference's presets: zamba2 at 3 layers (a unit of two Mamba2
blocks and the shared attention block, then a tail block), whisper-tiny,
qwen2-vl-2b and xlstm-1.3b (an mLSTM and an sLSTM block) as reduced.
Training: two ``make_train_step(mesh=...)`` steps of a seeded 4 x 32
batch with the family's side input (audio frames or patch embeddings,
seeded normals; whisper's learned decoder positions sized for SEQ, as
the dry-run sizes them), read as
tests/mesh_train_ranks.py reads its steps.  Serving: ``make_prefill_step``
on 4 prompts of 12 tokens (and their side inputs) into a cache of
MAX_SEQ positions past the patches, then DECODE_STEPS greedy
``make_serve_step`` steps, read as tests/seq_decode_ranks.py reads
them, with each step's collectives by axis and kind."""
import numpy as np
import torch

from mesh_train_ranks import flat, kinds_of
from repro_torch.bridge import params_from_numpy
from repro_torch.config import get_reduced_config, side_input
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as T
from repro_torch.training import optim
from repro_torch.tree import tree_leaves_with_path

F32 = dict(param_dtype="float32", activation_dtype="float32")
LAYERS = {"zamba2-7b": 3}
PRESETS = ("baseline", "dp", "infer-tp", "ep", "infer-tp2")
STEPS, BATCH, SEQ = 2, 4, 32
OPT = optim.OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
PROMPT, MAX_SEQ, DECODE_STEPS = 12, 24, 4


def cases(arch: str) -> tuple:
    """(name, arch, (D, M), preset): every preset on (2, 2), then
    ``baseline`` on (1, 4) (every weight's cut four ways over "model")
    and (4, 1) (the batch and FSDP four ways over "data")."""
    return tuple((f"{p}_2x2", arch, (2, 2), p) for p in PRESETS) + (
        ("baseline_1x4", arch, (1, 4), "baseline"),
        ("baseline_4x1", arch, (4, 1), "baseline"))


def config(arch: str):
    """The reduced config in fp32 (zamba2 at LAYERS' depth)."""
    cfg = get_reduced_config(arch).with_(**F32)
    return cfg.with_(n_layers=LAYERS.get(arch, cfg.n_layers))


def patches(cfg) -> int:
    return cfg.n_patches if cfg.family == "vlm" else 0


def with_side(cfg, tokens: np.ndarray, seed: int) -> dict:
    """``tokens`` and the family's side input for its rows (seeded
    normals: audio frames (B, F, d) or patch embeddings (B, P, d))."""
    out = {"tokens": tokens}
    side = side_input(cfg)
    if side is not None:
        rng = np.random.default_rng(seed)
        out[side[0]] = rng.standard_normal(
            (tokens.shape[0], side[1], cfg.d_model)).astype(np.float32)
    return out


def batches(cfg) -> list:
    """The global batches of the training steps."""
    rng = np.random.default_rng(5)
    return [with_side(cfg, rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
                      .astype(np.int32), 100 + s) for s in range(STEPS)]


def prompts(cfg) -> dict:
    """The serving prompts and their side inputs."""
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return with_side(cfg, toks, 12)


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def one_train(m, arch: str, preset: str, np_tree) -> dict:
    """Two training steps on this rank's slices and rows of the mesh
    ``m``: per step the metrics, the collectives by axis and kind, and
    (every rank gathering, rank 0 keeping them) the whole params and
    moments; the slices' shapes."""
    cfg = config(arch)
    lmap = SH.train_map(preset)
    params = SH.shard_params(cfg, params_from_numpy(np_tree, cfg,
                                                    device="cpu"), m, lmap)
    shapes = {k: v.shape for k, v in flat(params).items()}
    state = optim.adamw_init(params, OPT)
    step = make_train_step(cfg, OPT, mesh=m, logical_map=lmap)
    steps = []
    for b in batches(cfg):
        rows = SH.shard_batch(b, m, lmap)
        m.reset_counts()
        params, state, met = step(params, state, _tensors(rows))
        row = dict(metrics={k: float(v) for k, v in met.items()},
                   kinds=kinds_of(m))
        whole = {k: flat(SH.unshard_params(cfg, state[k] if k != "params"
                                           else params, m, lmap))
                 for k in ("params", "mu", "nu")}
        if m.rank == 0:
            row.update(whole)
        steps.append(row)
    return dict(steps=steps, shapes=shapes, coord=dict(m.coord),
                moment_shapes={k: v.shape for k, v in
                               flat(state["mu"]).items()})


def one_serve(m, arch: str, preset: str, np_tree) -> dict:
    """The prefill and DECODE_STEPS greedy decode steps on this rank's
    slices and rows of the mesh ``m``: its rows (start, count), the
    logits of the prefill's last position and of each step, the greedy
    tokens, the cache's leaf shapes after the prefill and after the
    steps, and the collectives by axis and kind of the prefill and of
    each step."""
    cfg = config(arch)
    lmap = SH.train_map(preset)
    params = SH.shard_params(cfg, params_from_numpy(np_tree, cfg,
                                                    device="cpu"), m, lmap)
    batch = prompts(cfg)
    rows = SH.shard_batch(batch, m, lmap)
    toks = batch["tokens"]
    n = len(rows["tokens"])
    first = next(i for i in range(0, BATCH, n)
                 if np.array_equal(toks[i:i + n], rows["tokens"]))
    P = patches(cfg)
    prefill = make_prefill_step(cfg, mesh=m, logical_map=lmap,
                                max_seq=MAX_SEQ + P)
    step = make_serve_step(cfg, mesh=m, logical_map=lmap)
    m.reset_counts()
    logits, cache = prefill(params, _tensors(rows))
    kinds = [kinds_of(m)]
    shapes = {"/".join(p): tuple(t.shape)
              for p, t in tree_leaves_with_path(cache)}
    out, tokens = [logits[:, 0].numpy().copy()], []
    nxt = logits[:, 0].argmax(-1)
    for t in range(DECODE_STEPS):
        tokens.append(nxt.numpy().copy())
        m.reset_counts()
        logits, cache = step(params, cache, nxt[:, None].to(torch.int32),
                             P + PROMPT + t)
        kinds.append(kinds_of(m))
        out.append(logits[:, 0].numpy().copy())
        nxt = logits[:, 0].argmax(-1)
    return dict(rows=(first, n), logits=out, tokens=tokens,
                cache_shapes=shapes, coord=dict(m.coord), kinds=kinds,
                after_shapes={"/".join(p): tuple(t.shape)
                              for p, t in tree_leaves_with_path(cache)})


def run_world(mesh, archs: tuple, trees: dict) -> dict:
    """Every training and serving case of ``archs`` in one world (a
    mesh of each shape, built once)."""
    torch.manual_seed(0)
    out = {"rank": mesh.rank}
    meshes = {}
    for arch in archs:
        for name, _, shape, preset in cases(arch):
            if shape not in meshes:
                meshes[shape] = make_mesh(*shape)
            m = meshes[shape]
            out[("train", arch, name)] = one_train(m, arch, preset,
                                                   trees[arch])
            out[("serve", arch, name)] = one_serve(m, arch, preset,
                                                   trees[arch])
    return out


def local_shapes(arch: str, preset: str, shape) -> dict:
    """The rule's slice shapes (``sharding.param_plan`` on the whole
    shapes) of every leaf on a ``shape`` mesh."""
    from repro_torch.models.pspec import MeshShape
    cfg = config(arch)
    whole = T.param_shapes(cfg, max_seq=SEQ)
    plan = SH.param_plan(cfg, whole, MeshShape(("data", "model"), shape),
                         SH.train_map(preset))
    return {"/".join(p): SH.local_shape(t.shape, *plan[p])
            for p, t in tree_leaves_with_path(whole)}
