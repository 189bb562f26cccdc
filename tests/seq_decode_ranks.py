"""What each rank of the port's sequence-cut decode test runs
(tests/test_torch_seq_decode.py, a 4-rank gloo world on the CPU).  It
imports the port and numpy and nothing of JAX, so a rank spawned with
``repro_torch.launch.mesh.spawn`` never loads it.

Each case is one reduced fp32 config on a (2, 2) mesh under one preset:
``make_prefill_step`` on the rank's slices of the params and rows of the
batch, its cache laid out for MAX_SEQ positions (the rank's slice by the
reference's ``cache_logical_axes``), then DECODE_STEPS greedy
``make_serve_step`` steps on that cache."""
import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.config import get_reduced_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.tree import tree_leaves_with_path

F32 = dict(param_dtype="float32", activation_dtype="float32")
MESH = (2, 2)
BATCH, PROMPT, MAX_SEQ, DECODE_STEPS = 4, 10, 24, 4
WINDOW = 8                  # the ring cases: 8 slots, 4 a rank
# (name, arch, preset, sliding window)
CASES = (("dense_baseline", "qwen1.5-4b", "baseline", 0),
         ("dense_infer_tp", "qwen1.5-4b", "infer-tp", 0),
         ("dense_infer_tp2", "qwen1.5-4b", "infer-tp2", 0),
         ("mqa_baseline", "granite-20b", "baseline", 0),
         ("mqa_infer_tp", "granite-20b", "infer-tp", 0),
         ("mqa_infer_tp2", "granite-20b", "infer-tp2", 0),
         ("moe_baseline", "qwen3-moe-30b-a3b", "baseline", 0),
         ("moe_infer_tp", "qwen3-moe-30b-a3b", "infer-tp", 0),
         ("moe_infer_tp2", "qwen3-moe-30b-a3b", "infer-tp2", 0),
         ("mla_baseline", "deepseek-v3-671b", "baseline", 0),
         ("mla_infer_tp2", "deepseek-v3-671b", "infer-tp2", 0),
         ("mqa_ring_baseline", "granite-20b", "baseline", WINDOW),
         ("dense_ring_infer_tp", "qwen1.5-4b", "infer-tp", WINDOW))


def config(arch: str, window: int = 0):
    """The reduced config in fp32 (with a sliding window of ``window``)."""
    cfg = get_reduced_config(arch).with_(**F32)
    return cfg.with_(sliding_window=window) if window else cfg


def prompts(cfg) -> np.ndarray:
    return np.random.default_rng(11).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)


def one_case(mesh, arch: str, preset: str, window: int, np_tree) -> dict:
    """The case on this rank: its batch rows (start, count), the logits of
    the prefill's last position and of each decode step (its rows, fp32
    numpy), the greedy tokens, the cache's leaf shapes after the prefill
    and after the steps, and the collectives of each decode step by
    axis."""
    cfg = config(arch, window)
    lmap = SH.train_map(preset)
    full = params_from_numpy(np_tree, cfg, device="cpu")
    params = SH.shard_params(cfg, full, mesh, lmap)
    toks = prompts(cfg)
    rows = SH.shard_batch({"tokens": toks}, mesh, lmap)["tokens"]
    first = next(i for i in range(0, BATCH, len(rows))
                 if np.array_equal(toks[i:i + len(rows)], rows))
    prefill = make_prefill_step(cfg, mesh=mesh, logical_map=lmap,
                                max_seq=MAX_SEQ)
    step = make_serve_step(cfg, mesh=mesh, logical_map=lmap)
    logits, cache = prefill(params, {"tokens": torch.as_tensor(rows)})
    shapes = {"/".join(p): tuple(t.shape)
              for p, t in tree_leaves_with_path(cache)}
    out = [logits[:, 0].numpy().copy()]
    tokens, collectives = [], []
    nxt = logits[:, 0].argmax(-1)
    for t in range(DECODE_STEPS):
        tokens.append(nxt.numpy().copy())
        mesh.reset_counts()
        logits, cache = step(params, cache, nxt[:, None].to(torch.int32),
                             PROMPT + t)
        collectives.append(dict(mesh.counts))
        out.append(logits[:, 0].numpy().copy())
        nxt = logits[:, 0].argmax(-1)
    return dict(rows=(first, len(rows)), logits=out, tokens=tokens,
                cache_shapes=shapes, coord=dict(mesh.coord),
                after_shapes={"/".join(p): tuple(t.shape)
                              for p, t in tree_leaves_with_path(cache)},
                collectives=collectives)


def run_world(mesh, trees: dict) -> dict:
    """Every case on a (2, 2) mesh of the world."""
    torch.manual_seed(0)
    m = make_mesh(*MESH)
    return {name: one_case(m, arch, preset, window, trees[(arch, window)])
            for name, arch, preset, window in CASES}
