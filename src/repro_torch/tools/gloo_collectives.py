"""Time the ways gloo can run the mesh's all-reduces, gathers,
reduce-scatters and all-to-alls of CUDA tensors, with the ranks sharing
one card.

    PYTHONPATH=src python3 -m repro_torch.tools.gloo_collectives \\
        [--ranks 4] [--mb 4,64,256]

Spawns ``--ranks`` processes on cuda:0 joined by gloo as a (2, ranks/2)
(data, model) mesh and times, over "data" and over the whole mesh, at
each result size (MiB of bf16; a reduce-scatter's and an all-reduce's
input is fp32 of as many entries): an all-reduce staged through a pinned
host buffer (``launch.mesh``'s path since the xLSTM slice) and gloo's
all-reduce of the CUDA tensor itself (its path before); a gather staged
through pinned host buffers and gloo's
CPU ``all_gather_into_tensor`` (``launch.mesh``'s path), through
pageable ones, and as an all-reduce of a zero-filled buffer on the card;
a reduce-scatter staged through gloo's CPU ``reduce_scatter_tensor``, as
an all-reduce on a pinned host copy and a slice, and as gloo's
all-reduce of the CUDA tensor and a slice (``launch.mesh``'s path); an
all-to-all staged through pinned and through pageable buffers.  Prints
one JSON object of host-clock ms a call (synced, the slowest rank's),
and the card's name and power limit.  Needs a card."""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def _bench(mesh0, sizes) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh(2, mesh0.size // 2, device=mesh0.device)
    dev = m.device
    out = {}

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        m.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def pinned(shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    for axis in ("data", None):
        group, n, i, _ = m._axis(axis)
        for mb in sizes:
            k = mb * 2 ** 20 // 2 // n              # bf16 entries a slice
            local = torch.ones(k, dtype=torch.bfloat16, device=dev)
            whole = torch.ones(k * n, dtype=torch.float32, device=dev)
            x = torch.ones(k * n, dtype=torch.bfloat16, device=dev)

            def all_reduce_pinned():
                hx = pinned(whole.shape, whole.dtype)
                hx.copy_(whole)
                dist.all_reduce(hx, group=group)
                return whole.copy_(hx, non_blocking=True)

            def all_reduce_cuda():
                dist.all_reduce(whole, group=group)
                return whole

            def gather_pinned():
                hx = pinned(local.shape, local.dtype)
                hx.copy_(local)
                ho = pinned((k * n,), local.dtype)
                dist.all_gather_into_tensor(ho, hx, group=group)
                return ho.to(dev, non_blocking=True)

            def gather_pageable():
                ho = torch.empty(k * n, dtype=local.dtype)
                dist.all_gather_into_tensor(ho, local.cpu(), group=group)
                return ho.to(dev)

            def gather_zero_filled_all_reduce():
                buf = torch.zeros(k * n, dtype=local.dtype, device=dev)
                buf.narrow(0, i * k, k).copy_(local)
                dist.all_reduce(buf.view(torch.int32), group=group)
                return buf

            def reduce_scatter_pinned():
                hx = pinned(whole.shape, whole.dtype)
                hx.copy_(whole)
                ho = pinned((k,), whole.dtype)
                dist.reduce_scatter_tensor(ho, hx, group=group)
                return ho.to(dev, non_blocking=True)

            def reduce_scatter_host_all_reduce():
                hx = pinned(whole.shape, whole.dtype)
                hx.copy_(whole)
                dist.all_reduce(hx, group=group)
                return hx.narrow(0, i * k, k).to(dev, non_blocking=True)

            def reduce_scatter_cuda_all_reduce():
                t = whole.clone()
                dist.all_reduce(t, group=group)
                return t.narrow(0, i * k, k).clone()

            def all_to_all_pinned():
                hx = pinned(x.shape, x.dtype)
                hx.copy_(x)
                ho = pinned(x.shape, x.dtype)
                dist.all_to_all_single(ho, hx, group=group)
                return ho.to(dev, non_blocking=True)

            def all_to_all_pageable():
                hx = x.cpu()
                ho = torch.empty_like(hx)
                dist.all_to_all_single(ho, hx, group=group)
                return ho.to(dev)

            for fn in (all_reduce_pinned, all_reduce_cuda,
                       gather_pinned, gather_pageable,
                       gather_zero_filled_all_reduce, reduce_scatter_pinned,
                       reduce_scatter_host_all_reduce,
                       reduce_scatter_cuda_all_reduce, all_to_all_pinned,
                       all_to_all_pageable):
                key = f"{axis or 'mesh'}_{mb}MB {fn.__name__}"
                out[key] = timed(fn, 20 if mb < 256 else 5)
    return out


def main(argv=None) -> dict:
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mb", default="4,64,256")
    args = ap.parse_args(argv)
    sizes = [int(v) for v in args.mb.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    ranks = spawn(_bench, args.ranks, sizes, device="cuda", threads=1,
                  timeout_s=900)
    res = {k: max(r[k] for r in ranks) for k in ranks[0]}
    print(smi)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
