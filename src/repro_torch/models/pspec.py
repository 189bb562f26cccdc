"""Logical-axis sharding rules: the twin of the JAX package's
``models/pspec.py``, as plain Python over a mesh described by its axis
names and sizes.

Model code names tensor dims by *logical* axes ("batch", "model",
"expert", ...); the installed rules map each logical name to physical
mesh axes.  Outside any rules (unit tests, one device) nothing is
sharded.

Divisibility-aware: a logical annotation is dropped for a tensor dim
whose size the mapped mesh axes do not divide (15 query heads cannot
shard over model=16, so smollm's attention stays replicated).

The reference's ``shard()`` and ``named_sharding()`` have no
counterpart.  GSPMD places the reference's tensors from annotations;
the port places them itself: ``launch.sharding`` cuts each rank's
slices of the params and pools by these rules, and the model code
reads the installed mesh (``current_mesh``) for the collectives that
join the ranks.  ``pspec_for`` returns a plain tuple of mesh-axis
entries per dim (None, an axis name, or a tuple of names) where the
reference returns a ``PartitionSpec`` of the same entries.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence

# logical axis name -> tuple of physical mesh axes
DEFAULT_LOGICAL_MAP = {
    "batch": ("pod", "data"),      # pod dropped when absent from the mesh
    "fsdp": ("pod", "data"),
    "model": ("model",),
    "expert": ("model",),
    "seq": ("model",),             # sequence sharding (MQA KV caches)
}

_STATE: dict = {"mesh": None, "map": None, "reads": None, "seq": None,
                "memo": {}}


@dataclass(frozen=True)
class MeshShape:
    """A mesh as these rules see it: axis names and their sizes (no
    devices).  ``launch.mesh.ServingMesh`` has the same three
    attributes."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def set_mesh_rules(mesh, logical_map=None, reads=None, seq=None) -> None:
    """Install ``mesh`` and ``logical_map``; ``reads``: a training
    mesh's {param path: (FSDP dim or None, mesh axes, FSDP axes or
    None)} of the leaves whose gradient is summed over those axes where
    the model reads them (``layers.gathered``): the leaves FSDP cuts,
    gathered over the FSDP axes, and the unembedding weight; ``seq``:
    the mesh axes (a spec entry)
    over which a decode step's contiguous k/v cache holds its positions
    cut, resolved once by the step that installs the rules (None:
    whole)."""
    _STATE["mesh"] = mesh
    _STATE["map"] = dict(logical_map or DEFAULT_LOGICAL_MAP)
    _STATE["reads"] = reads
    _STATE["seq"] = seq
    _STATE["memo"] = {}


@contextmanager
def mesh_rules(mesh, logical_map=None, reads=None, seq=None):
    prev = dict(_STATE)
    set_mesh_rules(mesh, logical_map, reads, seq)
    try:
        yield
    finally:
        _STATE.update(prev)


def current_mesh():
    return _STATE["mesh"]


def resolved(key, make):
    """``make()`` resolved once while the installed rules stand (a
    step installs its rules once a call): kept under ``key`` until
    ``set_mesh_rules`` runs again."""
    memo = _STATE["memo"]
    if key not in memo:
        memo[key] = make()
    return memo[key]


def cache_seq():
    """The installed "seq" axes of a contiguous k/v cache's positions
    (``set_mesh_rules``), or None."""
    return _STATE["seq"]


def read_plan() -> Optional[dict]:
    """The installed {param path: (FSDP dim or None, mesh axes, FSDP
    axes or None)}, or None."""
    return _STATE["reads"]


def batch_axes() -> tuple:
    """The mesh axes the installed rules cut the batch rows over (the
    "batch" logical axis's, those of size > 1), in the map's order;
    () without a mesh.  A training mesh's ranks each hold their rows of
    the global batch, so the loss and the MoE's routing statistics sum
    over these axes."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return ()
    return tuple(a for a in _STATE["map"].get("batch", ("batch",))
                 if mesh.shape.get(a, 1) > 1)


def batch_rank() -> tuple:
    """(index, count) of this rank's block of rows of the global batch
    under the installed rules (its position along ``batch_axes``, the
    first axis major); (0, 1) when no axis cuts the batch."""
    mesh = _STATE["mesh"]
    i, n = 0, 1
    for a in batch_axes():
        i, n = i * mesh.shape[a] + mesh.index(a), n * mesh.shape[a]
    return i, n


def _resolve(logical: Optional[str], dim_size: int, mesh):
    """Map a logical name to the subset of physical axes that exist in
    the mesh and evenly divide dim_size."""
    if logical is None:
        return None
    axes = _STATE["map"].get(logical, (logical,))
    present = [a for a in axes if a in mesh.shape]
    if not present:
        return None
    factor = math.prod(mesh.shape[a] for a in present)
    if dim_size % factor != 0:
        # drop trailing axes until it divides (or give up)
        while present:
            present.pop()
            factor = math.prod(mesh.shape[a] for a in present) if present else 1
            if present and dim_size % factor == 0:
                break
        if not present:
            return None
    return tuple(present) if len(present) > 1 else present[0]


def pspec_for(shape: Sequence[int], logical: Sequence[Optional[str]]
              ) -> Optional[tuple]:
    """The mesh-axis entry of each dim of a tensor of ``shape`` whose
    dims carry the ``logical`` names, under the installed rules; None
    without a mesh."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    assert len(shape) == len(logical), (shape, logical)
    used: set = set()
    entries = []
    for size, name in zip(shape, logical):
        axes = _resolve(name, size, mesh)
        # a physical axis may appear only once in a spec
        if axes is not None:
            flat = axes if isinstance(axes, tuple) else (axes,)
            if any(a in used for a in flat):
                axes = None
            else:
                used.update(flat)
        entries.append(axes)
    return tuple(entries)


def entry_of(logical: str, n: int):
    """The spec entry of a dim that the installed rules cut ``n`` ways
    under ``logical``: the longest leading part of the logical name's
    mesh axes (those in the mesh, in the map's order) whose ranks number
    ``n`` (``_resolve`` drops trailing axes where a count does not
    divide, so a cut's ways name its axes); None when no part does.  A
    weight or cache that holds this rank's ``1/n`` of a dim finds its
    axes here, and the model joins its ranks over them."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    axes = [a for a in _STATE["map"].get(logical, (logical,))
            if a in mesh.shape]
    while axes:
        if math.prod(mesh.shape[a] for a in axes) == n:
            return tuple(axes) if len(axes) > 1 else axes[0]
        axes.pop()
    return None


def entry_size(entry) -> int:
    """How many ways one spec entry cuts its dim on the installed mesh."""
    if entry is None:
        return 1
    flat = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(_STATE["mesh"].shape[a] for a in flat)


def shard_count(logical: Optional[str], dim_size: int) -> int:
    """How many ways a dim of ``dim_size`` shards under ``logical`` with
    the installed rules (1 without rules, or when divisibility forces
    the replication fallback).  The serving engine reports per-device
    KV-pool and expert-dispatch accounting with this, and the port cuts
    heads, widths and experts by it."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return 1
    return entry_size(_resolve(logical, dim_size, mesh))
