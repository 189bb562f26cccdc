"""Dry-run: build every (architecture x input shape) step at its full
config on a ``(16, 16)`` mesh (``--multi-pod``: the reference's
``(2, 16, 16)`` mesh of axes ("pod", "data", "model")), as rank 0 sees
it, on the meta device, and count its work: the twin of the JAX
package's ``launch/dryrun.py``.

The reference lowers and compiles each step on 512 placeholder host
devices and reads the compiled module (memory, cost, collectives).  The
port has no compiler to ask: it runs rank 0's step on meta tensors
(shapes and dtypes, no data) on a ``launch.mesh.CountingMesh``, whose
collectives issue nothing, under ``analysis.hlo``'s counter.  Nothing is
computed or allocated, and no card is needed.  The step is the one the
card runs: ``launch.steps``'s train, prefill or serve step under the
preset's rules, on rank 0's slices of the params and moments
(``sharding.shard_params``), its rows of the batch and its slices of
the contiguous cache (``sharding.shard_cache``), with each kernel
charged its own work (``kernels.ops``'s meta route).  A decode step
reads its cache full, to ``seq_len``; its result gives the rank's cache
bytes beside those the reference's rule would leave it
(``rule_cache_bytes``: they differ where the port's cut departs, as the
xLSTM state's whole heads do).

Results carry the reference's keys (FLOPs and bytes per device,
collectives by kind with ``total_link_bytes``, memory, params; ``mesh``
"16x16" or "2x16x16") and the port's: collectives by mesh axes (one
axis, several joined by commas, or "mesh"), memory by stage of the
step, kernel launches, the backend whose collective path is modelled,
and ``trace_s`` in place of ``lower_s`` / ``compile_s``.  The
reference's ``xla_cost_analysis`` and ``--save-hlo`` have no twin
(there is no XLA module).  ``analysis.roofline`` turns the results into
bounds.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k [--mesh 16x16 | --multi-pod] [--sharding dp] \\
        [--moe-dispatch scatter] [--backend gloo] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod] --json DIR
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.hlo import analyze_step
from repro_torch.config import (ARCH_IDS, INPUT_SHAPES, ShapeSpec,
                                get_config, supports_shape)
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import CountingMesh
from repro_torch.models import pspec as PS
from repro_torch.training import optim
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map

PRODUCTION_MESH = (16, 16)
MULTI_POD_MESH = (2, 16, 16)


def _moment_dtype(cfg) -> str:
    # deepseek-scale optimizer state: bf16 moments for >=100B-param
    # configs, as the reference's dry-run keeps them
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def skip_reason(cfg, shape: ShapeSpec):
    """Why the port builds no step for this pair, or None."""
    if not supports_shape(cfg, shape):
        return "unsupported pair (DESIGN.md §6)"
    return None


def _batch_map(lmap: dict, mesh, rows: int) -> dict:
    """``lmap`` with "batch" cut to the axes that divide ``rows``, as the
    reference's divisibility-aware rule places a batch (long_500k's one
    row replicates)."""
    with PS.mesh_rules(mesh, lmap):
        (entry,) = PS.pspec_for((rows,), ["batch"])
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    have = tuple(a for a in lmap.get("batch", ()) if a in mesh.shape)
    return lmap if axes == have else dict(lmap, batch=axes)


def _rule_cache_bytes(cfg, cache, mesh, lmap) -> int:
    """The bytes a rank's slice of the whole ``cache`` (meta tensors)
    takes by the reference's ``cache_logical_axes`` under ``lmap``."""
    n = 0
    with PS.mesh_rules(mesh, lmap):
        for path, t in tree_leaves_with_path(cache):
            spec = PS.pspec_for(tuple(t.shape), SH.cache_logical_axes(
                cfg, path, tuple(t.shape)))
            k = t.numel()
            for e in spec:
                k //= PS.entry_size(e)
            n += k * t.element_size()
    return n


def _rows(tree, mesh, lmap):
    """Rank 0's rows of every leaf, each its own storage."""
    return tree_map(torch.clone, SH.shard_batch(tree, mesh, lmap))


def build_step(cfg, shape: ShapeSpec, *, mode: str = "flash",
               moe_dispatch: str = "einsum", sharding: str = "baseline",
               remat: bool = True, mesh: tuple = PRODUCTION_MESH,
               backend: str = "nccl") -> dict:
    """Rank 0's step of ``cfg`` at ``shape``, built on the meta
    device and not run: {"fn", "args", "mesh" (the ``CountingMesh`` of
    ``mesh``'s (data, model) or (pod, data, model) sizes, None on one
    rank), "lmap", and the bytes of the rank's "param_bytes",
    "moment_bytes" (train), "cache_bytes" and "rule_cache_bytes"
    (decode: the cache's slice, and the reference's rule's) and its
    "batch_rows"}.  A train step on a mesh updates its params and
    moments in place, as ``make_train_step(mesh=...)`` does."""
    cmesh = (CountingMesh(*mesh, backend=backend) if math.prod(mesh) > 1
             else None)
    lmap = SH.train_map(sharding)
    if cmesh is not None:
        lmap = _batch_map(lmap, cmesh, shape.global_batch)
    full = SP.params_specs(cfg, max_seq=shape.seq_len)
    params = (SH.shard_params(cfg, full, cmesh, lmap) if cmesh is not None
              else full)
    out = {"mesh": cmesh, "lmap": lmap, "param_bytes": _tree_bytes(params)}
    on_mesh = dict(mesh=cmesh, logical_map=lmap) if cmesh else {}

    def rows(tree):
        return _rows(tree, cmesh, lmap) if cmesh else tree
    if shape.kind == "train":
        opt_cfg = optim.OptimConfig(moment_dtype=_moment_dtype(cfg))
        opt_state = optim.adamw_init(params, opt_cfg)
        out["moment_bytes"] = (_tree_bytes(opt_state["mu"])
                               + _tree_bytes(opt_state["nu"]))
        batch = rows(SP.batch_specs(cfg, shape))
        out["fn"] = ST.make_train_step(
            cfg, opt_cfg, mode=mode, moe_dispatch=moe_dispatch, remat=remat,
            **on_mesh)
        out["args"] = (params, opt_state, batch)
        tokens = batch["tokens"]
    elif shape.kind == "prefill":
        batch = rows(SP.batch_specs(cfg, shape))
        out["fn"] = ST.make_prefill_step(cfg, mode=mode,
                                         moe_dispatch=moe_dispatch,
                                         **on_mesh)
        out["args"] = (params, batch)
        tokens = batch["tokens"]
    else:
        d = SP.decode_specs(cfg, shape)
        cache = (SH.shard_cache(cfg, d["cache"], cmesh, lmap)
                 if cmesh else d["cache"])
        out["cache_bytes"] = _tree_bytes(cache)
        out["rule_cache_bytes"] = (_rule_cache_bytes(cfg, d["cache"], cmesh,
                                                     lmap)
                                   if cmesh else out["cache_bytes"])
        tokens = rows({"tokens": d["tokens"]})["tokens"]
        out["fn"] = ST.make_serve_step(cfg, **on_mesh)
        out["args"] = (params, cache, tokens, d["pos"])
    out["batch_rows"] = tokens.shape[0]
    return out


def dryrun_one(arch: str, shape_name, *, multi_pod: bool = False,
               mode: str = "flash", moe_dispatch: str = "einsum",
               window_override: int | None = None,
               sharding: str = "baseline", remat: bool = True,
               mesh: tuple = PRODUCTION_MESH, backend: str = "nccl",
               cfg=None, verbose: bool = True) -> dict:
    """Count rank 0's step of ``arch`` (or of ``cfg``, a config
    cut to size) at ``shape_name`` (an ``INPUT_SHAPES`` name or a
    ``ShapeSpec``) on a ``mesh`` = (data, model) or (pod, data, model)
    ``CountingMesh`` of ``backend``'s path under the ``sharding`` preset
    (``build_step``); ``multi_pod``: on MULTI_POD_MESH, as the
    reference's.  A (1, 1) mesh builds the one-rank step.  Returns the
    result row (see the module docstring), or ``{"skipped": True,
    "reason": ...}``."""
    if multi_pod:
        mesh = MULTI_POD_MESH
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg = SP.variant_for_shape(cfg or get_config(arch), shape)
    if window_override is not None:
        cfg = cfg.with_(sliding_window=window_override)
    why = skip_reason(cfg, shape)
    if why:
        return {"arch": arch, "shape": shape.name, "skipped": True,
                "reason": why}
    t0 = time.time()
    built = build_step(cfg, shape, mode=mode, moe_dispatch=moe_dispatch,
                       sharding=sharding, remat=remat, mesh=mesh,
                       backend=backend)
    fn, args, cmesh = (built.pop(k) for k in ("fn", "args", "mesh"))
    built.pop("lmap")
    hlo = analyze_step(fn, *args, mesh=cmesh)
    del fn, args
    mem = hlo["memory"]
    res = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh),
        "n_devices": math.prod(mesh), "kind": shape.kind, "mode": mode,
        "moe_dispatch": moe_dispatch, "sharding": sharding,
        "sliding_window": cfg.sliding_window, "backend": backend,
        "n_layers": cfg.n_layers, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "trace_s": round(time.time() - t0, 2),
        "flops_per_device": hlo["flops"],
        "bytes_per_device": hlo["bytes"],
        "collectives": {**hlo["coll"],
                        "total_link_bytes": hlo["total_link_bytes"]},
        "collectives_by_axis": hlo["coll_by_axis"],
        "memory": {"argument_bytes": mem["argument_bytes"],
                   "output_bytes": mem["output_bytes"],
                   "temp_bytes": mem["temp_bytes"],
                   "generated_code_bytes": None},
        "peak_bytes": mem["peak_bytes"],
        "argument_bytes_by_input": mem["argument_bytes_by_input"],
        "memory_by_stage": mem["by_stage"],
        "kernels": hlo["kernels"],
        "kernel_flops_per_device": hlo["kernel_flops"],
        "kernel_bytes_per_device": hlo["kernel_bytes"],
        **built,
        "params_total": cfg.param_count(),
        "params_active": cfg.param_count(active_only=True),
    }
    if verbose:
        print(json.dumps(res, indent=2))
    return res


def parse_mesh(text: str) -> tuple:
    """"DxM" -> (D, M); "PxDxM" -> (P, D, M)."""
    sizes = tuple(int(n) for n in text.lower().split("x"))
    if len(sizes) not in (2, 3):
        raise ValueError(f"mesh {text!r}: DxM or PxDxM")
    return sizes


def run_all(out_dir: str, **kw) -> list:
    """``dryrun_one`` over ARCH_IDS x INPUT_SHAPES into ``out_dir`` (a
    file a pair, skipped when it exists, as the reference's); a skipped
    pair's row says why.  Returns the pairs that raised."""
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    suffix = "" if kw.get("sharding", "baseline") == "baseline" \
        else "__" + kw["sharding"]
    pods = "multi" if kw.get("multi_pod") else "single"
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            tag = f"{arch}__{shape}__{pods}{suffix}"
            out = os.path.join(out_dir, tag + ".json")
            if os.path.exists(out):
                print("skip (exists):", tag)
                continue
            print("=== ", tag, flush=True)
            try:
                res = dryrun_one(arch, shape, verbose=False, **kw)
            except Exception as e:           # noqa: BLE001 - recorded
                traceback.print_exc()
                failures.append(tag)
                res = {"arch": arch, "shape": shape, "error": str(e)[:2000]}
            with open(out, "w") as f:
                json.dump(res, f, indent=2)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="16x16",
                    help="DxM (data x model) or PxDxM (pod x data x model)")
    ap.add_argument("--backend", default="nccl",
                    choices=CountingMesh.BACKENDS)
    ap.add_argument("--mode", default="flash", choices=["flash", "naive"])
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "scatter"])
    ap.add_argument("--sharding", default="baseline",
                    choices=list(SH.SHARDING_PRESETS))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--json", default=None,
                    help="output file (single) or directory (--all)")
    args = ap.parse_args(argv)
    kw = dict(multi_pod=args.multi_pod, mode=args.mode,
              moe_dispatch=args.moe_dispatch,
              sharding=args.sharding, remat=not args.no_remat,
              window_override=args.window, mesh=parse_mesh(args.mesh),
              backend=args.backend)
    if args.all:
        if not args.json:
            ap.error("--all requires --json DIR")
        t0 = time.time()
        failures = run_all(args.json, **kw)
        print(f"FAILURES: {failures} ({time.time() - t0:.1f} s)")
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    res = dryrun_one(args.arch, args.shape, **kw)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
