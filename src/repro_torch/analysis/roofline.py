"""Roofline over the dry-run's results: the twin of the JAX package's
``analysis/roofline.py``, under one H100's data-sheet constants
(``launch.mesh``) where the reference has a TPU v5e's.

Per (arch x shape x mesh), every term per device (the dry-run counts
one rank's step, so nothing is divided by the device count):

    compute    = FLOPs / 989e12 (bf16 tensor cores, dense: every FLOP
                 at the fastest rate, so a lower bound)
    memory     = bytes / 3.35e12 (HBM3)
    collective = the sum over the mesh's sets of axes of each set's link
                 bytes (every kind's result bytes, the MoE's all-to-all
                 among them; an all-reduce's twice) over NVLink
                 (450e9 B/s a GPU) where the set's group of ranks
                 fits in one 8-GPU node, else over the node's
                 network (50e9 B/s a GPU); ranks fill nodes in order, so
                 at (16, 16) "model" (16 consecutive ranks) spans two
                 nodes and "data" (a stride of 16) sixteen, and at
                 (2, 16, 16) a "pod" group (a stride of 256) crosses
                 nodes always.  A result without ``collectives_by_axis``
                 (the reference's) takes its ``total_link_bytes`` over
                 the network.

The bound is the largest term.  MODEL_FLOPS = 6 * N * D (6 * N_active *
D for MoE; D the tokens processed; 2 * N * D for inference) over the
device count, against the counted FLOPs: the ratio shows remat,
causal-masking waste and replication across the mesh.  These are
bounds from counts, not measurements.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

from repro_torch.config import INPUT_SHAPES
from repro_torch.launch.mesh import (BF16_FLOP_PER_S, GPUS_PER_NODE,
                                     HBM_BYTES_PER_S, NETWORK_BYTES_PER_S,
                                     NVLINK_BYTES_PER_S)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_dev: float
    hlo_flops_per_dev: float
    useful_ratio: float
    note: str = ""

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def tokens_for(shape_name: str) -> int:
    s = INPUT_SHAPES[shape_name]
    if s.kind == "decode":
        return s.global_batch            # one new token per sequence
    return s.seq_len * s.global_batch


def _tokens(res: dict) -> int:
    """``tokens_for`` the result's shape, or of its own ``seq_len`` and
    ``global_batch`` where the shape is not an ``INPUT_SHAPES`` one."""
    if res["shape"] in INPUT_SHAPES:
        return tokens_for(res["shape"])
    if res["kind"] == "decode":
        return res["global_batch"]
    return res["seq_len"] * res["global_batch"]


def model_flops(res: dict) -> float:
    """6*N*D global for a train step (forward and backward); 2*N*D for
    inference."""
    n = res["params_active"]
    d = _tokens(res)
    mult = 6.0 if res["kind"] == "train" else 2.0
    return mult * n * d


def axis_in_node(mesh: str, axis: str) -> bool:
    """Whether rank 0's group on ``axis`` (a count key of
    ``launch.mesh.Mesh``: "data", "model", "pod", several joined by
    commas, or "mesh": all ranks) of a ``"DxM"`` or ``"PxDxM"`` mesh
    lies in one node of GPUS_PER_NODE GPUs, ranks filling the nodes in
    order (the last axis minor)."""
    sizes = [int(n) for n in mesh.split("x")]
    names = ("data", "model") if len(sizes) == 2 else ("pod", "data",
                                                        "model")
    axes = names if axis == "mesh" else tuple(axis.split(","))
    ranks = [0]
    stride = 1
    for name, n in reversed(list(zip(names, sizes))):
        if name in axes:
            ranks = [r + i * stride for i in range(n) for r in ranks]
        stride *= n
    return len({r // GPUS_PER_NODE for r in ranks}) == 1


def link_bandwidth(mesh: str, axis: str) -> float:
    return NVLINK_BYTES_PER_S if axis_in_node(mesh, axis) \
        else NETWORK_BYTES_PER_S


def collective_s(res: dict) -> float:
    by_axis = res.get("collectives_by_axis")
    if not by_axis:
        return res["collectives"]["total_link_bytes"] / NETWORK_BYTES_PER_S
    return sum(kinds["link_bytes"] / link_bandwidth(res["mesh"], axis)
               for axis, kinds in by_axis.items() if kinds["link_bytes"])


def improvement_note(row: "RooflineRow", res: dict) -> str:
    if row.dominant == "collective":
        return ("cut the collective volume: gather the vocab-parallel "
                "logits' loss instead of the logits, shard MoE dispatch "
                "with all-to-all, overlap FSDP gathers with compute on "
                "their own CUDA stream")
    if row.dominant == "memory":
        if res["kind"] == "decode":
            return ("decode is cache-bandwidth bound: shrink KV bytes "
                    "(MLA-style latent cache / int8 KV) or batch more "
                    "sequences per weight read")
        return ("fuse the elementwise chains (norms, rotary, SwiGLU, "
                "softmax-xent) into CUDA kernels that keep their tiles "
                "in shared memory; capture the step in a CUDA graph")
    return ("increase arithmetic intensity: larger per-device batch or "
            "wider TP sharding of heads")


def row_for(res: dict) -> RooflineRow:
    """The roofline row of one dry-run result."""
    n_dev = res["n_devices"]
    flops = res["flops_per_device"]
    ct = flops / BF16_FLOP_PER_S
    mt = res["bytes_per_device"] / HBM_BYTES_PER_S
    lt = collective_s(res)
    dom = max((("compute", ct), ("memory", mt), ("collective", lt)),
              key=lambda x: x[1])[0]
    mf = model_flops(res) / n_dev
    row = RooflineRow(
        arch=res["arch"], shape=res["shape"], mesh=res["mesh"],
        compute_s=ct, memory_s=mt, collective_s=lt, dominant=dom,
        model_flops_per_dev=mf, hlo_flops_per_dev=flops,
        useful_ratio=mf / flops if flops else float("nan"))
    row.note = improvement_note(row, res)
    return row


def load_rows(result_dir: str) -> list:
    rows = []
    for f in sorted(glob.glob(os.path.join(result_dir, "*.json"))):
        with open(f) as fh:
            res = json.load(fh)
        if res.get("skipped") or "error" in res:
            continue
        rows.append(row_for(res))
    return rows


def to_markdown(rows: list) -> str:
    out = ["| arch | shape | mesh | compute s | memory s | collective s "
           "| bound | MODEL/HLO | what moves the bound |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3f} "
            f"| {r.memory_s:.3f} | {r.collective_s:.3f} | **{r.dominant}** "
            f"| {r.useful_ratio:.3f} | {r.note} |")
    return "\n".join(out)
