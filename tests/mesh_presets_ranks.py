"""What each rank of the port's mesh-presets test runs
(tests/test_torch_mesh_presets.py, a 4-rank gloo world on the CPU).  It
imports the port and numpy and nothing of JAX, so a rank spawned with
``repro_torch.launch.mesh.spawn`` never loads it.

Training runs tests/mesh_train_ranks.py's ``one_case`` (two fp32 steps
of a 4 x 32 batch on the reduced configs of tests/sharded_ranks.py) and
serving tests/seq_decode_ranks.py's (a prefill of 4 x 10 tokens into a
cache of 24 positions, then 4 greedy decode steps), each on a (2, 2)
mesh under one of the presets this test adds: ``ep`` (the experts over
both axes, one a rank, the tokens over "data"), ``dp`` with experts
(the experts over "model", the tokens over both axes), and training
under ``infer-tp`` and ``infer-tp2``."""
import torch

import mesh_train_ranks as TR
import seq_decode_ranks as SR
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as T

MESH = (2, 2)
# (name, arch, preset): two fp32 training steps
TRAIN = (("moe_ep", "qwen3-moe-30b-a3b", "ep"),
         ("mla_ep", "deepseek-v3-671b", "ep"),
         ("moe_dp", "qwen3-moe-30b-a3b", "dp"),
         ("mla_dp", "deepseek-v3-671b", "dp"),
         ("dense_infer_tp", "smollm-360m", "infer-tp"),
         ("moe_infer_tp", "qwen3-moe-30b-a3b", "infer-tp"),
         ("dense_infer_tp2", "smollm-360m", "infer-tp2"),
         ("moe_infer_tp2", "qwen3-moe-30b-a3b", "infer-tp2"))
# (name, arch, preset): prefill and decode steps
SERVE = (("moe_ep", "qwen3-moe-30b-a3b", "ep"),
         ("mla_ep", "deepseek-v3-671b", "ep"),
         ("moe_dp", "qwen3-moe-30b-a3b", "dp"),
         ("mla_dp", "deepseek-v3-671b", "dp"))
# the engines' capacity bound on the serving prompts' 40 tokens (2 of 4
# experts each: 20 a mean expert), so the prefill overflows
CAPACITY = 8


def overflow(mesh, arch: str, preset: str, np_tree) -> int:
    """The overflowed routings of a prefill of the serving prompts under
    CAPACITY (the engines' bound): on a ``mesh`` under ``preset`` (this
    rank's rows, under ``make_prefill_step``'s rules), or on one rank
    (``mesh`` None)."""
    cfg = SR.config(arch)
    full = params_from_numpy(np_tree, cfg, device="cpu")
    toks = SR.prompts(cfg)
    if mesh is None:
        _, aux, _ = T.prefill(full, cfg, {"tokens": torch.as_tensor(toks)},
                              moe_capacity=CAPACITY, return_aux=True)
        return int(aux)
    lmap = SH.train_map(preset)
    params = SH.shard_params(cfg, full, mesh, lmap)
    rows = SH.shard_batch({"tokens": toks}, mesh, lmap)["tokens"]
    with ST._serve_rules(cfg, mesh, lmap)():    # make_prefill_step's
        _, aux, _ = T.prefill(params, cfg, {"tokens": torch.as_tensor(rows)},
                              moe_capacity=CAPACITY, return_aux=True)
    return int(aux)


def all_to_all_cases(mesh) -> list:
    """``Mesh.all_to_all`` over "data", "model" and the whole mesh, on
    buffers on the mesh's device whose slice j this rank fills for the
    rank at index j (its rank and j in every entry's bits, -0.0 and NaN
    among them): bf16, int8 and fp32, exchanged once and then back.
    Returns (axis, index, ranks on it, sent, once, twice), on the host."""
    out = []
    for axis in ("data", "model", None):
        n = mesh.size if axis is None else mesh.shape[axis]
        i = mesh.rank if axis is None else mesh.coord[axis]
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            sent = (torch.arange(n * 6).reshape(n, 6) + 16 * i).to(dtype)
            if dtype.is_floating_point:
                sent[0, 0], sent[-1, -1] = -0.0, float("nan")
            once = mesh.all_to_all(sent.to(mesh.device), 0, axis)
            twice = mesh.all_to_all(once, 0, axis)
            out.append((axis, i, n, sent, once.cpu(), twice.cpu()))
    return out


def card_collectives(mesh) -> dict:
    """On a (2, 2) mesh of ranks sharing the card under gloo (the CUDA
    tensors cross the host): the all-to-all cases, and over each axis a
    gather of bf16, int8 and fp32 slices (rank i's slice holds 16 * i +
    0..5, -0.0 and NaN among them) and a reduce-scatter of fp32 integers
    (rank r's entry e is (r + 1) * e: exact sums).  Returns them on the
    host, with this rank's coordinates."""
    m = make_mesh(*MESH, device=mesh.device)
    out = {"rank": m.rank, "coord": dict(m.coord),
           "all_to_all": all_to_all_cases(m), "gather": [],
           "reduce_scatter": []}
    for axis in ("data", "model", None):
        n = m.size if axis is None else m.shape[axis]
        i = m.rank if axis is None else m.coord[axis]
        for dtype in (torch.bfloat16, torch.int8, torch.float32):
            local = (torch.arange(6) + 16 * i).to(dtype)
            if dtype.is_floating_point:
                local[0], local[-1] = -0.0, float("nan")
            got = m.gather(local.to(m.device), 0, axis)
            out["gather"].append((axis, i, n, local, got.cpu()))
        x = torch.arange(n * 4, dtype=torch.float32) * (m.rank + 1)
        got = m.reduce_scatter(x.to(m.device), 0, axis)
        out["reduce_scatter"].append((axis, i, n, got.cpu()))
    return out


def run_world(mesh, train_trees: dict, serve_trees: dict) -> dict:
    """Every training and serving case on a (2, 2) mesh of the world,
    the overflow of each serving case, and the all-to-all round trips."""
    torch.manual_seed(0)
    m = make_mesh(*MESH)
    out = {"rank": m.rank, "coord": dict(m.coord),
           "all_to_all": all_to_all_cases(m)}
    for name, arch, preset in TRAIN:
        out[("train", name)] = TR.one_case(m, arch, MESH, preset,
                                           train_trees[arch])[0]
    for name, arch, preset in SERVE:
        out[("serve", name)] = SR.one_case(m, arch, preset, 0,
                                           serve_trees[arch])
        out[("overflow", name)] = overflow(m, arch, preset,
                                           serve_trees[arch])
    return out


def one_rank_overflow(arch: str, np_tree) -> int:
    return overflow(None, arch, None, np_tree)
