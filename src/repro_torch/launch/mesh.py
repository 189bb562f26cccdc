"""The mesh on ``torch.distributed``: the twin of the JAX package's
``launch/mesh.py``.

A mesh is ``(D, M)`` ranks of axes ``("data", "model")`` over one
process group: rank r sits at ``(r // M, r % M)``.  Its "model" axis
(the ranks of a row) carries tensor and expert parallelism, its "data"
axis (the ranks of a column) FSDP and the cut batch.  Serving uses
``D = 1`` (``make_serving_mesh``), training any ``(D, M)``
(``make_mesh``).  Both are multi-controller: one process per rank, each
running the same host-side code on its own slices of the params, the
moments, the batch and the KV pool (``launch.sharding``).  The ranks
meet only in the mesh's collectives, each taken over one axis (or the
whole mesh, ``axis=None``):

  * ``all_reduce``: the sum of partials (a row-parallel product's);
  * ``combine``: the all-reduce of a buffer each element of which is
    nonzero on at most one rank, summed as integers over the bits, so
    the result is every rank's contribution bit for bit (a vocab
    lookup);
  * ``gather``: the exact gather of equal slices along a dim, and
    ``reduce_scatter``: the sum, then this rank's slice;
  * ``all_to_all``: an even split along a dim, slice ``j`` to the rank
    at index ``j`` of the axis (the MoE's exchange with the experts'
    owners, ``models.moe``);
  * ``broadcast``, ``barrier`` and ``agree`` (every rank holds the same
    integers).

NCCL runs ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` natively.  Gloo takes CUDA tensors only for
all-reduce and broadcast, so under gloo a gather and an all-to-all of a
CUDA tensor cross the host: the tensor is copied into a pinned host
buffer, gloo runs the same collective there (natively on CPU tensors),
and the result is copied back to the card.  For a CUDA tensor gloo's
reduce-scatter through the host runs slower than its all-reduce of the
same tensor (``tools.gloo_collectives`` times both), so there a
reduce-scatter is the all-reduce and this rank's slice of the sum; CPU
tensors reduce-scatter natively.
The backend is the caller's choice and nothing switches it on a
failure: gloo on the CPU and when the ranks share one card, NCCL when
each rank has a GPU of its own.  The mesh counts the collectives it
issues, per axis (``counts``), and records each by kind and axis with
its result bytes (``coll``, ``by_axis``).

``CountingMesh`` has the same interface and issues nothing: each
collective returns a tensor of the shape the real one would, and is
recorded as the real one records it.  The dry-run
(``launch.dryrun``) builds a step on it on the meta device, as one rank
of a mesh of any size sees it.  The reference's
``make_production_mesh`` (a TPU pod) is not ported; its TPU v5e
constants are replaced by the H100's below, which the roofline
(``analysis.roofline``) and ``chip_smoke.py``'s kernel bounds read.
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

# One H100 SXM5 at its 700 W limit, from NVIDIA's H100 Tensor Core GPU
# data sheet (the SXM column) unless said otherwise:
BF16_FLOP_PER_S = 989e12           # bf16 tensor cores, dense (1979 sparse)
FP32_FLOP_PER_S = 67e12            # fp32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12          # HBM3
# NVLink 4, 18 links a GPU: a GPU's bytes each direction (900 GB/s both)
NVLINK_BYTES_PER_S = 450e9
# the node's network: one 400 Gb/s NDR InfiniBand adapter (ConnectX-7) a
# GPU on an 8-GPU HGX / DGX H100 (NVIDIA's DGX H100 user guide)
NETWORK_BYTES_PER_S = 50e9         # a GPU, each direction
GPUS_PER_NODE = 8

_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
AXES = ("data", "model")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "broadcast", "barrier")


class Mesh:
    """A ``(D, M)`` mesh of axes ``("data", "model")`` over a process
    group of ``size = D * M`` ranks.  ``rank`` is this process's index in
    the group, ``coord`` its (data, model) position, ``device`` the
    device its tensors live on, ``backend`` the group's.  ``groups``
    holds the group of this rank's row ("model") and of its column
    ("data") where the axis is neither 1 nor the whole mesh.  A mesh of
    one rank has no group: its collectives are the identity.  The
    serving mesh is ``D = 1``: every rank on "model"."""

    axis_names = AXES

    def __init__(self, group=None, *, rank: int = 0, size: int = 1,
                 ranks=None, device="cpu", backend: Optional[str] = None,
                 data: int = 1, groups: Optional[dict] = None):
        if size % data:
            raise ValueError(f"{size} ranks do not make {data} data rows")
        self.group = group
        self.rank = rank
        self.size = size
        self.ranks = list(ranks if ranks is not None else range(size))
        self.shape = {"data": data, "model": size // data}
        self.coord = {"data": rank // self.shape["model"],
                      "model": rank % self.shape["model"]}
        self.groups = dict(groups or {})
        self.device = torch.device(device)
        self.backend = backend
        self.reset_counts()
        # gloo takes CPU tensors for the small control collectives
        self._ctl = (self.device if backend == "nccl"
                     else torch.device("cpu"))

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend})")

    def index(self, axis) -> int:
        """This rank's position along ``axis``: one name, or a spec
        entry's tuple of names (the first major)."""
        i = 0
        for a in _names(axis):
            i = i * self.shape[a] + self.coord[a]
        return i

    def _axis(self, axis):
        """(group, ranks in it, this rank's index, count key) of
        ``axis``: "data", "model" (or a tuple of one), or None / both
        names in the mesh's order for the whole mesh."""
        names = () if axis is None else _names(axis)
        if not names or set(names) == set(AXES):
            if names and tuple(names) != AXES:
                raise ValueError(f"axes {names}: the whole mesh is "
                                 f"{AXES}, the first major")
            return self.group, self.size, self.rank, "mesh"
        (axis,) = names
        n = self.shape[axis]
        if n == self.size:
            return self.group, n, self.rank, axis
        return self.groups.get(axis), n, self.coord[axis], axis

    def _issue(self, key: str, kind: str, x: torch.Tensor = None) -> None:
        """Count one collective on ``key``'s axis: a ``kind`` whose result
        is ``x``, recorded with its bytes."""
        self.counts[key] += 1
        n = 0 if x is None else x.numel() * x.element_size()
        for rec in (self.coll[kind], self.by_axis[key][kind]):
            rec["count"] += 1
            rec["bytes"] += n

    # the wire: ``CountingMesh`` replaces these and issues nothing
    def _all_reduce(self, x, group, op=None) -> None:
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)

    def _all_gather(self, buf, x, group) -> None:
        self._through_host(dist.all_gather_into_tensor, buf, x, group)

    def _reduce_scatter(self, out, x, group) -> None:
        dist.reduce_scatter_tensor(out, x, group=group)

    def _all_to_all(self, out, x, group) -> None:
        self._through_host(dist.all_to_all_single, out, x, group)

    def _broadcast(self, x, src: int, group) -> None:
        dist.broadcast(x, src, group=group)

    def _staged(self, x) -> bool:
        """Whether gloo's collective of ``x`` crosses the host: a CUDA
        tensor under gloo."""
        return self.backend != "nccl" and x.device.type != "cpu"

    def _through_host(self, op, out, x, group) -> None:
        """``op(out, x)`` over ``group``: natively, or for a CUDA tensor
        under gloo on pinned host copies, the result copied back."""
        if not self._staged(x):
            op(out, x, group=group)
            return
        host_x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host_x.copy_(x)
        host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        op(host_out, host_x, group=group)
        out.copy_(host_out, non_blocking=True)

    def reset_counts(self) -> None:
        self.counts = {"data": 0, "model": 0, "mesh": 0}
        self.coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
        self.by_axis = {a: {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVE_KINDS}
                        for a in ("data", "model", "mesh")}

    # -- collectives --------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """Sum ``x`` over ``axis`` (default: the whole mesh), in place;
        returns it."""
        group, n, _, key = self._axis(axis)
        if n > 1:
            self._issue(key, "all-reduce", x)
            self._all_reduce(x, group)
        return x

    def combine(self, x: torch.Tensor, axis=None) -> torch.Tensor:
        """All-reduce ``x`` (contiguous) whose every element is nonzero
        on at most one rank of ``axis``, in place and bit for bit: the
        bits are summed as integers, so a -0.0 or a NaN crosses
        unchanged."""
        group, n, _, key = self._axis(axis)
        if n == 1:
            return x
        self._issue(key, "all-reduce", x)
        size = x.element_size()
        if size in (4, 8):
            self._all_reduce(x.view(_INT_OF_SIZE[size]), group)
        elif (x.numel() * size) % 4 == 0 \
                and (x.storage_offset() * size) % 4 == 0:
            # 1- and 2-byte lanes summed as int32 words: each lane is
            # nonzero on one rank at most, so no sum carries across lanes
            # (the word sum is the OR of the ranks' words)
            self._all_reduce(x.view(-1).view(torch.int32), group)
        else:                 # an odd length: the bits widened for the sum
            bits = x.view(_INT_OF_SIZE[size])
            wide = bits.to(torch.int32)
            self._all_reduce(wide, group)
            bits.copy_(wide)
        return x

    def gather(self, local: torch.Tensor, dim: int, axis=None
               ) -> torch.Tensor:
        """The whole tensor whose slice ``i`` along ``dim`` is the
        ``local`` of the rank at index ``i`` of ``axis`` (equal slices),
        on every rank of it, bit for bit."""
        group, n, _, key = self._axis(axis)
        if n == 1:
            return local
        dim %= local.dim()
        front = local.movedim(dim, 0).contiguous()
        buf = front.new_empty((n * local.shape[dim], *front.shape[1:]))
        self._issue(key, "all-gather", buf)
        self._all_gather(buf, front, group)
        return buf.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int, axis=None
                       ) -> torch.Tensor:
        """This rank's slice along ``dim`` (its index on ``axis``) of
        ``x`` summed over ``axis``: a new tensor."""
        group, n, i, key = self._axis(axis)
        if n == 1:
            return x
        dim %= x.dim()
        k = x.shape[dim] // n
        if self._staged(x):
            # staged through the host, gloo's reduce_scatter_tensor ran
            # 1.41x its all-reduce of the CUDA tensor over "data" at 256
            # MiB (tools.gloo_collectives): the sum, then the slice
            total = self.all_reduce(x.clone(), axis)
            return total.narrow(dim, i * k, k).clone()
        front = x.movedim(dim, 0).contiguous()
        out = front.new_empty((k, *front.shape[1:]))
        self._issue(key, "reduce-scatter", out)
        self._reduce_scatter(out, front, group)
        return out.movedim(0, dim).contiguous()

    def all_to_all(self, x: torch.Tensor, dim: int, axis=None
                   ) -> torch.Tensor:
        """``x`` cut evenly along ``dim`` into one slice a rank of
        ``axis``: slice ``j`` goes to the rank at index ``j``, and slice
        ``j`` of the result is what that rank sent this one (a new
        tensor; applied twice, the identity)."""
        group, n, _, key = self._axis(axis)
        if n == 1:
            return x
        dim %= x.dim()
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} along dim {dim} do not cut "
                             f"into {n} equal slices")
        front = x.movedim(dim, 0).contiguous()
        out = torch.empty_like(front)
        self._issue(key, "all-to-all", out)
        self._all_to_all(out, front, group)
        return out.movedim(0, dim).contiguous()

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place; returns it."""
        if self.size > 1:
            self._issue("mesh", "broadcast", x)
            self._broadcast(x, self.ranks[src], self.group)
        return x

    def barrier(self) -> None:
        if self.size > 1:
            self._issue("mesh", "barrier")
            dist.barrier(group=self.group)

    def agree(self, values) -> bool:
        """Whether every rank holds the same integers ``values`` (one
        all-reduce of (v, -v) under MAX)."""
        if self.size == 1:
            return True
        v = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
        both = torch.cat([v, -v]).to(self._ctl)
        self._issue("mesh", "all-reduce", both)
        self._all_reduce(both, self.group, dist.ReduceOp.MAX)
        return bool(torch.equal(both.cpu(), torch.cat([v, -v])))


# the serving code's name for the (1, n) mesh
ServingMesh = Mesh

class CountingMesh(Mesh):
    """Rank ``rank`` of a ``(data, model)`` mesh whose collectives issue
    nothing: each returns a tensor of the shape (and, where the real one
    works in place, the very tensor) the real one would, and is recorded
    in ``coll`` by kind ({kind: {"count", "bytes"}}, the result's bytes)
    and in ``by_axis`` by axis ("data", "model" or "mesh", as ``counts``)
    and kind, as the real mesh records them.  ``backend`` names the path
    modelled: NCCL's; "gloo", gloo's on CUDA tensors (its reduce-scatter
    an all-reduce); or "gloo-cpu", gloo's on CPU tensors (all native).
    Built on the meta device, with no process group."""

    BACKENDS = ("nccl", "gloo", "gloo-cpu")

    def __init__(self, data: int, model: int, *, rank: int = 0,
                 backend: str = "nccl"):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {self.BACKENDS}")
        super().__init__(rank=rank, size=data * model, device="meta",
                         backend=backend.split("-")[0], data=data)
        self._host = backend == "gloo-cpu"

    def __repr__(self) -> str:
        return (f"CountingMesh(rank={self.rank}, shape={self.shape}, "
                f"backend={self.backend}{'-cpu' if self._host else ''})")

    def _staged(self, x) -> bool:
        return self.backend != "nccl" and not self._host

    def _all_reduce(self, x, group, op=None) -> None:
        pass

    def _all_gather(self, buf, x, group) -> None:
        pass

    def _reduce_scatter(self, out, x, group) -> None:
        pass

    def _all_to_all(self, out, x, group) -> None:
        pass

    def _broadcast(self, x, src: int, group) -> None:
        pass

    def barrier(self) -> None:
        if self.size > 1:
            self._issue("mesh", "barrier")

    def agree(self, values) -> bool:
        """Counted as the real one's all-reduce; every rank agrees."""
        if self.size > 1:
            n = 2 * np.asarray(values).size
            self._issue("mesh", "all-reduce",
                        torch.empty((n,), dtype=torch.int64, device="meta"))
        return True


def _names(axis) -> tuple:
    return axis if isinstance(axis, tuple) else (axis,)


def _default_device(device, backend: str, rank: int):
    if device is None:
        return torch.device("cuda", rank) if backend == "nccl" else "cpu"
    return device


def make_serving_mesh(n_devices: Optional[int] = None, *,
                      device=None) -> Optional[Mesh]:
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
        return Mesh(device=device or "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} outside 1..{world}")
    device = _default_device(device, backend, rank)
    if n == world:
        return Mesh(None, rank=rank, size=world, device=device,
                    backend=backend)
    group = dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group, rank=rank, size=n, ranks=range(n), device=device,
                backend=backend)


def make_mesh(data: int, model: int, *, device=None) -> Mesh:
    """The ``(data, model)`` training mesh over the whole initialized
    default process group (``data * model`` must be its size; without a
    group, the one-rank mesh).  Every rank must call this: it creates
    each row's "model" group and each column's "data" group, every rank
    all of them in the same order."""
    n = data * model
    if not dist.is_available() or not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs an "
                               "initialized process group")
        return Mesh(device=device or "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} ranks, "
                         f"the group has {world}")
    backend = dist.get_backend()
    groups = {}
    if 1 < model < n:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups["model"] = g
    if 1 < data < n:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups["data"] = g
    return Mesh(None, rank=rank, size=n, device=_default_device(
        device, backend, rank), backend=backend, data=data, groups=groups)


def make_local_mesh() -> Mesh:
    """The one-rank mesh for tests and examples."""
    return Mesh()


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
