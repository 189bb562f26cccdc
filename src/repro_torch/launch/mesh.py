"""The mesh on ``torch.distributed``: the twin of the JAX package's
``launch/mesh.py``.

A mesh is ``(D, M)`` ranks of axes ``("data", "model")`` over one
process group: rank r sits at ``(r // M, r % M)``; or, with a third
axis first and major as the reference orders it, ``(P, D, M)`` ranks
of axes ``("pod", "data", "model")``, rank r at ``(r // (D M),
(r // M) % D, r % M)``.  Its "model" axis (the ranks of a row) carries
tensor and expert parallelism, its "data" axis (the ranks of a column)
FSDP and the cut batch, with "pod" beside it where the mesh has one
(the reference's default map cuts the batch and FSDP over ("pod",
"data")).  Serving uses ``D = 1`` (``make_serving_mesh``), training
any shape (``make_mesh``).  Both are multi-controller: one process per
rank, each running the same host-side code on its own slices of the
params, the moments, the batch and the KV pool (``launch.sharding``).
The ranks meet only in the mesh's collectives, each taken over a set of
its axes (one, several in the mesh's order, or the whole mesh,
``axis=None``):

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
``all_to_all_single`` natively.  Gloo takes CUDA tensors for all-reduce
and broadcast only, and its all-reduce of a CUDA tensor runs slower than
of a pinned host copy (``tools.gloo_collectives`` times both), so under
gloo every collective of a CUDA tensor but the broadcast crosses the
host: the tensor is copied into a pinned host buffer, gloo runs the same
collective there (natively on CPU tensors), and the result is copied
back to the card.  For a CUDA tensor gloo's reduce-scatter through the
host runs slower than its all-reduce of the same tensor, so there a
reduce-scatter is the all-reduce and this rank's slice of the sum; CPU
tensors reduce-scatter natively.
The backend is the caller's choice and nothing switches it on a
failure: gloo on the CPU and when the ranks share one card, NCCL when
each rank has a GPU of its own.  The mesh counts the collectives it
issues, per set of axes (``counts``: keyed by the axis's name, the
names of several joined by commas, or "mesh" for the whole mesh), and
records each by kind and axes with its result bytes (``coll``,
``by_axis``).

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
import math
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
POD_AXES = ("pod", "data", "model")
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "broadcast", "barrier")


class Mesh:
    """A ``(D, M)`` mesh of axes ``("data", "model")``, or with ``pod``
    a ``(P, D, M)`` mesh of axes ``("pod", "data", "model")``, over a
    process group of ``size`` ranks.  ``rank`` is this process's index in
    the group, ``coord`` its position on each axis, ``device`` the device
    its tensors live on, ``backend`` the group's.  ``groups`` holds the
    group of each set of axes (a name, or a tuple of names in the mesh's
    order) of this rank, where the set's ranks are neither 1 nor the
    whole mesh.  A mesh of one rank has no group: its collectives are
    the identity.  The serving mesh is ``D = 1``: every rank on
    "model"."""

    axis_names = AXES

    def __init__(self, group=None, *, rank: int = 0, size: int = 1,
                 ranks=None, device="cpu", backend: Optional[str] = None,
                 data: int = 1, groups: Optional[dict] = None,
                 pod: Optional[int] = None):
        outer = data * (pod or 1)
        if size % outer:
            raise ValueError(f"{size} ranks do not make {outer} data rows")
        self.group = group
        self.rank = rank
        self.size = size
        self.ranks = list(ranks if ranks is not None else range(size))
        M = size // outer
        if pod is None:
            self.shape = {"data": data, "model": M}
            self.coord = {"data": rank // M, "model": rank % M}
        else:
            self.axis_names = POD_AXES
            self.shape = {"pod": pod, "data": data, "model": M}
            self.coord = {"pod": rank // (data * M),
                          "data": (rank // M) % data, "model": rank % M}
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

    def key(self, axis) -> str:
        """The count key of a set of axes: "mesh" for the whole mesh
        (None, or every axis), else the names of those of more than one
        rank (of all, where none has), in the mesh's order, joined by
        commas: on a (2, 1, 2) mesh ("pod", "data") is "pod", the group
        of the same ranks."""
        names = () if axis is None else _names(axis)
        if not names or set(names) == set(self.axis_names):
            return "mesh"
        return ",".join(self._live(names))

    def _live(self, names: tuple) -> tuple:
        return tuple(a for a in names if self.shape[a] > 1) or names

    def _axis(self, axis):
        """(group, ranks in it, this rank's index, count key) of
        ``axis``: one name, several in the mesh's order (a tuple), or
        None / every name for the whole mesh."""
        names = () if axis is None else _names(axis)
        if names and tuple(a for a in self.axis_names if a in names) \
                != tuple(names):
            raise ValueError(f"axes {names}: the mesh's are "
                             f"{self.axis_names}, the first major")
        key = self.key(axis)
        if key == "mesh":
            return self.group, self.size, self.rank, key
        n = _count(self.shape, names)
        if n == self.size:
            return self.group, n, self.rank, key
        live = self._live(names)
        return (self.groups.get(live if len(live) > 1 else live[0]), n,
                self.index(names), key)

    def _issue(self, key: str, kind: str, x: torch.Tensor = None) -> None:
        """Count one collective on ``key``'s axes: a ``kind`` whose result
        is ``x``, recorded with its bytes."""
        self.counts[key] += 1
        n = 0 if x is None else x.numel() * x.element_size()
        for rec in (self.coll[kind], self.by_axis[key][kind]):
            rec["count"] += 1
            rec["bytes"] += n

    # the wire: ``CountingMesh`` replaces these and issues nothing
    def _all_reduce(self, x, group, op=None) -> None:
        op = op or dist.ReduceOp.SUM
        if not self._staged(x):
            dist.all_reduce(x, op=op, group=group)
            return
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        dist.all_reduce(host, op=op, group=group)
        x.copy_(host, non_blocking=True)

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
        keys = _keys(self.axis_names)
        self.counts = {a: 0 for a in keys}
        self.coll = {k: {"count": 0, "bytes": 0} for k in COLLECTIVE_KINDS}
        self.by_axis = {a: {k: {"count": 0, "bytes": 0}
                            for k in COLLECTIVE_KINDS} for a in keys}

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
    """Rank ``rank`` of a ``(data, model)`` mesh, or of a ``(pod, data,
    model)`` mesh given three sizes, whose collectives issue
    nothing: each returns a tensor of the shape (and, where the real one
    works in place, the very tensor) the real one would, and is recorded
    in ``coll`` by kind ({kind: {"count", "bytes"}}, the result's bytes)
    and in ``by_axis`` by axes (the keys of ``counts``) and kind, as the
    real mesh records them.  ``backend`` names the path modelled:
    NCCL's; "gloo", gloo's on CUDA tensors (each collective but the
    broadcast staged through the host, its reduce-scatter an
    all-reduce); or "gloo-cpu", gloo's on CPU tensors (all native).
    Built on the meta device, with no process group."""

    BACKENDS = ("nccl", "gloo", "gloo-cpu")

    def __init__(self, *shape: int, rank: int = 0, backend: str = "nccl"):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {self.BACKENDS}")
        if len(shape) not in (2, 3):
            raise ValueError(f"a mesh of (data, model) or (pod, data, "
                             f"model) ranks, not {shape}")
        pod = shape[0] if len(shape) == 3 else None
        super().__init__(rank=rank, size=math.prod(shape), device="meta",
                         backend=backend.split("-")[0], data=shape[-2],
                         pod=pod)
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


def _count(shape: dict, names) -> int:
    return math.prod(shape[a] for a in names)


def _sets(names: tuple) -> list:
    """Every proper, non-empty subset of the axes ``names``, each in
    their order: the single axes first."""
    return [tuple(a for i, a in enumerate(names) if m >> i & 1)
            for m in sorted(range(1, 2 ** len(names) - 1),
                            key=lambda m: (bin(m).count("1"), m))]


def _keys(names: tuple) -> list:
    """The count keys of a mesh of axes ``names``: each proper subset's
    (``Mesh.key``), then "mesh"."""
    return [",".join(s) for s in _sets(names)] + ["mesh"]


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


def make_mesh(*shape: int, device=None) -> Mesh:
    """The ``(data, model)`` training mesh, or given three sizes the
    ``(pod, data, model)`` one, over the whole initialized default
    process group (the sizes' product must be its size; without a group,
    the one-rank mesh).  Every rank must call this: it creates the group
    of each set of axes (``Mesh.groups``) for every rank, all of them in
    the same order."""
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh of (data, model) or (pod, data, model) "
                         f"ranks, not {shape}")
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {shape} mesh needs an initialized "
                               "process group")
        return Mesh(device=device or "cpu")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{world}")
    backend = dist.get_backend()
    pod = shape[0] if len(shape) == 3 else None
    coords = [Mesh(rank=r, size=n, data=shape[-2], pod=pod).coord
              for r in range(n)]
    names = tuple(coords[0])
    sizes = dict(zip(names, shape))
    groups = {}
    for axes in _sets(names):
        if not 1 < _count(sizes, axes) < n:
            continue
        rest = [a for a in names if a not in axes]
        # one group for each place along the other axes
        for at in sorted({tuple(c[a] for a in rest) for c in coords}):
            members = [r for r, c in enumerate(coords)
                       if tuple(c[a] for a in rest) == at]
            g = dist.new_group(members)
            if rank in members:
                groups[axes if len(axes) > 1 else axes[0]] = g
    return Mesh(None, rank=rank, size=n, device=_default_device(
        device, backend, rank), backend=backend, data=shape[-2],
        groups=groups, pod=pod)


def make_local_mesh() -> Mesh:
    """The one-rank mesh for tests and examples."""
    return Mesh()


def _rank_main(rank: int, n_ranks: int, fn, args, backend: str, device,
               threads, timeout_s: float, tmp: str, shape) -> None:
    """One spawned rank: join the group over ``tmp``'s file store, run
    ``fn(mesh, *args)`` (the serving mesh, or ``make_mesh(*shape)``),
    write its result for the parent (or, when it raises, the time and
    its traceback, then raise)."""
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
        mesh = (make_mesh(*shape, device=dev) if shape
                else make_serving_mesh(device=dev))
        out = fn(mesh, *args)
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
          threads: Optional[int] = None, timeout_s: float = 600.0,
          shape: Optional[tuple] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``n_ranks`` new processes (the "spawn"
    start method; ``fn`` and ``args`` must pickle), joined by a
    ``backend`` process group over a ``file://`` store in a fresh
    temporary directory, so concurrent worlds never share a port.
    Returns each rank's result, in rank order.  A rank that raises makes
    this raise with every failed rank's traceback, the earliest first
    (the first failure; the others' are often its echo: a peer that
    left a collective), and the other ranks are terminated;
    ``shape``: the ``(data, model)`` or ``(pod, data, model)`` mesh
    ``fn`` gets (``make_mesh``; default the serving mesh of every rank);
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
                                     threads, timeout_s, tmp, shape),
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
