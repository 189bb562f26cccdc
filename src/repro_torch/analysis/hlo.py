"""The work of one step, counted op by op as it is dispatched: the twin of
the JAX package's ``analysis/hlo.py``.

The reference reads a compiled XLA module's HLO text.  The port runs
eagerly and has no HLO, so this module counts the aten ops a step
dispatches: ``StepCounter`` is a ``TorchDispatchMode``, and the step is
run under it, as a rule on meta tensors (``launch.dryrun``), so nothing
is computed or allocated.  It sees what the card would run: the forward,
autograd's backward and ``torch.utils.checkpoint``'s recompute (as the
reference's HLO sees remat), the optimizer, and the kernel routes, which
charge their own work (``kernels.ops``; a kernel is one op of the step,
not the plain version's ops).  Per device, as the reference's numbers
are (the step is one rank's):

  * flops: 2 * |out| * K for matrix products (``torch.utils.flop_counter``'s
    formulas for mm, addmm, bmm, baddbmm, to which ``einsum`` and
    ``matmul`` lower), |out| for every other op that computes (elementwise
    ops and reductions, as ``hlo.py`` counts them), none for views,
    allocations and data movement; a kernel route its ``work()``'s.
  * bytes: eager truth, not the reference's TPU fusion model: each op
    reads its operands and writes its result (a copy its source and its
    destination, a fill its destination), views and allocations are
    free; a kernel route its ``work()``'s; a collective its result.
  * collectives: those of the mesh the step runs on (a
    ``launch.mesh.CountingMesh``), by kind and by axis, with the
    reference's ``total_link_bytes`` (an all-reduce moves its bytes twice).
  * memory: the arguments' bytes, the outputs' (storages that are not
    the arguments'), and the peak of the step's live storages besides
    the arguments (each output's untyped storage is followed with
    ``weakref.finalize``); by stage, where the step marks its stages
    (``mark``): live and peak bytes, arguments included, at each mark.

The reference's HLO parser (``parse_module``, ``Analyzer``) has no
twin: there is no text to parse.
"""
from __future__ import annotations

import time
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# allocations and metadata: no bytes, no flops
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset,
         _aten.resize_.default, _aten.sym_size.int, _aten.sym_stride.int,
         _aten.sym_numel.default, _aten.sym_storage_offset.default,
         _aten.is_same_size.default, _aten._local_scalar_dense.default}
# writes that read nothing of their destination
_OVERWRITE = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
              _aten.zero_.default}
# data movement and constants: bytes, no flops
_MOVERS = {p for p in (
    "copy_", "clone", "cat", "stack", "index", "index_put", "index_put_",
    "_index_put_impl_", "index_select", "gather", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "index_add", "index_add_", "embedding",
    "slice_scatter", "select_scatter", "as_strided_scatter",
    "constant_pad_nd", "repeat", "sort", "topk", "fill_", "zero_", "zeros",
    "ones", "full", "arange", "zeros_like", "ones_like", "full_like",
    "scalar_tensor", "lift_fresh_copy", "new_zeros", "new_ones",
    "new_full", "flip", "roll", "masked_scatter")}
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "broadcast", "barrier")

_ACTIVE: list = []


def active():
    """The innermost ``StepCounter`` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def charge_kernel(name: str, work: dict) -> None:
    """Charge the active counter one launch of kernel ``name`` and its
    ``work`` ({"bytes", "flops", ...}, the kernel wrapper's ``work()``);
    nothing without one."""
    c = active()
    if c is not None:
        c.kernels[name] = c.kernels.get(name, 0) + 1
        c.flops += work["flops"]
        c.bytes += work["bytes"]
        c.kernel_flops += work["flops"]
        c.kernel_bytes += work["bytes"]


def mark(stage: str) -> None:
    """Record the active counter's live bytes now and its peak since the
    previous mark, under ``stage`` ("forward", "backward", "update");
    nothing without a counter."""
    c = active()
    if c is not None:
        c.mark(stage)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class StepCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it (see the module docstring).
    ``hold(args)`` names the arguments' storages before the step runs;
    the rest are followed from their first op to their release."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.ops: Counter = Counter()
        self.kernels: dict = {}
        self.stages: dict = {}
        self.arg_bytes = 0
        self._held: set = set()
        self._live: dict = {}
        self.live = 0
        self.peak = 0
        self._window = 0

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        for t in _tensors(out):
            self._follow(t)
        return out

    # -- work ----------------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        if func in _FREE or func.is_view:
            return
        self.ops[func.__name__] += 1
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if func in _OVERWRITE:
            ins = ins[1:]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet.__name__ not in _MOVERS:
            self.flops += sum(t.numel() for t in outs)

    # -- memory --------------------------------------------------------------
    def hold(self, tree) -> int:
        """Name ``tree``'s storages as the step's arguments (live
        throughout, counted apart); returns their bytes."""
        n = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self._held:
                self._held.add(id(st))
                n += st.nbytes()
        self.arg_bytes += n
        return n

    def _follow(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        self._window = max(self._window, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def mark(self, stage: str) -> None:
        self.stages[stage] = dict(live_bytes=self.arg_bytes + self.live,
                                  peak_bytes=self.arg_bytes + self._window)
        self._window = self.live

    def new_bytes(self, tree) -> int:
        """Bytes of ``tree``'s storages that are not the arguments'."""
        seen, n = set(), 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self._held and id(st) not in seen:
                seen.add(id(st))
                n += st.nbytes()
        return n


def _coll(mesh) -> tuple:
    empty = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    if mesh is None or not hasattr(mesh, "coll"):
        return empty, {a: dict(empty) for a in ("data", "model", "mesh")}
    return ({k: dict(v) for k, v in mesh.coll.items()},
            {a: {k: dict(v) for k, v in kinds.items()}
             for a, kinds in mesh.by_axis.items()})


def link_bytes(coll: dict) -> int:
    """The reference's ``total_link_bytes``: each collective's result
    bytes, an all-reduce's twice (reduce-scatter then all-gather)."""
    return sum(v["bytes"] * (2 if k == "all-reduce" else 1)
               for k, v in coll.items())


def analyze_step(fn, *args, mesh=None) -> dict:
    """Run ``fn(*args)`` under a ``StepCounter`` (on meta tensors nothing
    runs) and return the reference's ``analyze_hlo`` keys: ``flops``,
    ``bytes``, ``coll`` ({kind: {"count", "bytes"}}) and
    ``total_link_bytes``, and the port's: ``coll_by_axis`` ({axis: {kind:
    ...}}, with each axis's ``link_bytes``), ``kernels`` (launches by
    kernel), ``ops`` (calls by aten op), ``memory`` (``argument_bytes``,
    ``argument_bytes_by_input``, one an argument, ``output_bytes``,
    ``temp_bytes``: the peak of the step's live storages less the
    outputs', ``peak_bytes``: arguments and that peak, and ``by_stage``)
    and ``trace_s``.  ``mesh``: the ``CountingMesh`` the step runs on;
    its counts are reset first and read after."""
    if mesh is not None:
        mesh.reset_counts()
    c = StepCounter()
    by_input = [c.hold(a) for a in args]
    t0 = time.perf_counter()
    with c:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    out_bytes = c.new_bytes(out)
    del out
    coll, by_axis = _coll(mesh)
    c.bytes += sum(v["bytes"] for v in coll.values())
    for kinds in by_axis.values():
        kinds["link_bytes"] = link_bytes(kinds)
    return {
        "flops": c.flops, "bytes": c.bytes, "coll": coll,
        "total_link_bytes": link_bytes(coll), "coll_by_axis": by_axis,
        "kernel_flops": c.kernel_flops, "kernel_bytes": c.kernel_bytes,
        "kernels": dict(c.kernels), "ops": dict(c.ops),
        "memory": {"argument_bytes": c.arg_bytes,
                   "argument_bytes_by_input": by_input,
                   "output_bytes": out_bytes,
                   "temp_bytes": max(c.peak - out_bytes, 0),
                   "peak_bytes": c.arg_bytes + c.peak,
                   "by_stage": c.stages},
        "trace_s": trace_s}
