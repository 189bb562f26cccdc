"""The serving mesh on ``torch.distributed``: the twin of the JAX
package's ``launch/mesh.py``.

Serving is multi-controller: one process per rank, each running the
same host-side engine and scheduler on the same trace, its model
compute on its own slices of the params and KV pool
(``launch.sharding``).  The ranks meet only in the mesh's collectives:

  * ``all_reduce``: the sum of a row-parallel product's partials;
  * ``combine``: the all-reduce of a buffer each element of which is
    nonzero on at most one rank, summed as integers over the bits, so
    the result is every rank's contribution bit for bit (a vocab
    lookup, a gather);
  * ``gather``: each rank's slice written into a zero-filled buffer of
    the whole, then ``combine``: exact, and it needs no ``all_gather``,
    which gloo does not take on CUDA tensors;
  * ``broadcast``, ``barrier`` and ``agree`` (every rank holds the same
    integers).

The backend is the caller's choice and nothing switches it on a
failure: gloo on the CPU and when the ranks share one card, NCCL when
each rank has a GPU of its own.  The reference's ``make_production_mesh``
and its TPU v5e constants describe a TPU pod and are not ported.
"""
from __future__ import annotations

import faulthandler
import glob
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class ServingMesh:
    """A ``(1, n)`` mesh of axes ``("data", "model")``: every rank of a
    process group on the tensor-parallel "model" axis, as the
    reference's ``make_serving_mesh``.  ``rank`` is this process's index
    in the group, ``device`` the device its params live on, ``backend``
    the group's.  A mesh of one rank has no group: its collectives are
    the identity."""

    axis_names = ("data", "model")

    def __init__(self, group=None, *, rank: int = 0, size: int = 1,
                 ranks=None, device="cpu", backend: Optional[str] = None):
        self.group = group
        self.rank = rank
        self.size = size
        self.ranks = list(ranks if ranks is not None else range(size))
        self.device = torch.device(device)
        self.backend = backend
        # gloo takes CPU tensors for the small control collectives
        self._ctl = (self.device if backend == "nccl"
                     else torch.device("cpu"))

    @property
    def shape(self) -> dict:
        return {"data": 1, "model": self.size}

    def __repr__(self) -> str:
        return (f"ServingMesh(rank={self.rank}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend})")

    # -- collectives --------------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def combine(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce ``x`` (contiguous) whose every element is nonzero
        on at most one rank, in place and bit for bit: the bits are
        summed as integers, so a -0.0 or a NaN crosses unchanged."""
        if self.size == 1:
            return x
        bits = x.view(_INT_OF_SIZE[x.element_size()])
        if x.element_size() in (4, 8):
            dist.all_reduce(bits, group=self.group)
        else:                 # 1- and 2-byte bits widened for the sum
            wide = bits.to(torch.int32)
            dist.all_reduce(wide, group=self.group)
            bits.copy_(wide)
        return x

    def gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor whose rank-``r`` slice along ``dim`` is rank
        ``r``'s ``local`` (equal slices, in rank order), on every rank:
        a zero-filled buffer, this rank's slice written in, ``combine``."""
        if self.size == 1:
            return local
        dim %= local.dim()
        shape = list(local.shape)
        k = shape[dim]
        shape[dim] = k * self.size
        buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
        if buf.numel() == 0:
            return buf
        buf.narrow(dim, self.rank * k, k).copy_(local)
        return self.combine(buf)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns it."""
        if self.size > 1:
            dist.broadcast(x, self.ranks[src], group=self.group)
        return x

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def agree(self, values) -> bool:
        """Whether every rank holds the same integers ``values`` (one
        all-reduce of (v, -v) under MAX)."""
        if self.size == 1:
            return True
        v = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
        both = torch.cat([v, -v]).to(self._ctl)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        return bool(torch.equal(both.cpu(), torch.cat([v, -v])))


def make_serving_mesh(n_devices: Optional[int] = None, *,
                      device=None) -> Optional[ServingMesh]:
    """The serving mesh over the initialized default process group: all
    of its ranks on "model", or its first ``n_devices`` (every rank must
    call this then, as it creates a group; a rank outside gets None).
    Without an initialized group, the trivial one-rank mesh (the
    reference's (1, 1) mesh on one device).  ``device``: this rank's
    device (default: ``cuda:<rank>`` under NCCL, else the CPU)."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} ranks needs an "
                               "initialized process group")
        return ServingMesh(device=device or "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world}")
    if device is None:
        device = torch.device("cuda", rank) if backend == "nccl" else "cpu"
    if n == world:
        return ServingMesh(None, rank=rank, size=world, device=device,
                           backend=backend)
    group = dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return ServingMesh(group, rank=rank, size=n, ranks=range(n),
                       device=device, backend=backend)


def make_local_mesh() -> ServingMesh:
    """The one-rank mesh for tests and examples."""
    return ServingMesh()


def _rank_main(rank: int, n_ranks: int, fn, args, backend: str, device,
               threads, timeout_s: float, tmp: str) -> None:
    """One spawned rank: join the group over ``tmp``'s file store, run
    ``fn(mesh, *args)``, write its result for the parent (or, when it
    raises, the time and its traceback, then raise)."""
    faulthandler.enable()
    if threads:
        torch.set_num_threads(threads)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl"
                           else dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=n_ranks, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(make_serving_mesh(device=dev), *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r} rank {rank}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, *args, backend: str = "gloo", device="cuda",
          threads: Optional[int] = None, timeout_s: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` in ``n_ranks`` new processes (the "spawn"
    start method; ``fn`` and ``args`` must pickle), joined by a
    ``backend`` process group over a ``file://`` store in a fresh
    temporary directory, so concurrent worlds never share a port.
    Returns each rank's result, in rank order.  A rank that raises makes
    this raise with every failed rank's traceback, the earliest first
    (the first failure; the others' are often its echo: a peer that
    left a collective), and the other ranks are terminated;
    ``timeout_s`` bounds each collective.  ``threads``: each rank's
    intra-op thread count.  ``device``: the ranks' (``cuda``, every rank
    on the current card under gloo or on ``cuda:<rank>`` under NCCL,
    unless the caller asks for ``cpu``; without a GPU ``cuda`` raises
    here, before any rank starts)."""
    import torch.multiprocessing as mp
    resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        try:
            mp.start_processes(_rank_main,
                               args=(n_ranks, fn, args, backend, device,
                                     threads, timeout_s, tmp),
                               nprocs=n_ranks, join=True,
                               start_method="spawn")
        except Exception as e:
            errs = []
            for path in glob.glob(os.path.join(tmp, "rank*.err")):
                with open(path) as f:
                    errs.append(f.read())
            errs.sort(key=lambda t: float(t.split()[0]))
            raise RuntimeError("mesh ranks failed, earliest first:\n"
                               + "\n".join(errs)) from e
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
