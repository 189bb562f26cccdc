"""Checkpointing: the twin of the JAX package's ``checkpoint/store.py``,
file layout byte for byte, through the port's own MessagePack
(``checkpoint.msgpack_codec``; the ``msgpack`` package is not used).

A single ``.ckpt`` file holds
    {"meta": {...}, "leaves": {path: {dtype, shape, codec, raw}}}
with leaves in ``jax.tree_util`` order (dict keys sorted, lists by
index) and paths joined by "/".  Each leaf records its ``codec``
("zstd" when ``zstandard`` imports, else "raw"), so a file written with
one loads without it whenever it is raw.  bf16 leaves are stored as
their ``uint16`` bit patterns under the dtype name "bfloat16".  Leaves
may be tensors or numpy arrays; loads return CPU tensors.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.tree import tree_leaves_with_path, tree_unflatten

try:
    import zstandard as zstd
except ImportError:              # pragma: no cover - env dependent
    zstd = None

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


def _host_array(leaf):
    """(dtype name, shape, payload bytes) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(t.shape), t.numpy().tobytes()
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name == "bfloat16":
        arr = arr.view(np.uint16)
    return name, list(arr.shape), np.ascontiguousarray(arr).tobytes()


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype))
                            .reshape(shape).copy())


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None,
                    level: int = 3) -> int:
    """Returns the on-disk size in bytes."""
    cctx = zstd.ZstdCompressor(level=level) if zstd is not None else None
    leaves = {}
    for p, leaf in tree_leaves_with_path(tree):
        name, shape, payload = _host_array(leaf)
        leaves["/".join(str(k) for k in p)] = {
            "dtype": name,
            "shape": shape,
            "codec": "zstd" if cctx is not None else "raw",
            "raw": cctx.compress(payload) if cctx is not None else payload,
        }
    blob = packb({"meta": meta or {}, "leaves": leaves})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def _decode_payload(rec: dict) -> bytes:
    # files written before codecs were recorded are always zstd
    codec = rec.get("codec", "zstd")
    if codec == "raw":
        return rec["raw"]
    if codec == "zstd":
        if zstd is None:
            raise RuntimeError(
                "checkpoint leaf is zstd-compressed but the 'zstandard' "
                "module is not installed")
        return zstd.ZstdDecompressor().decompress(rec["raw"])
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_checkpoint_raw(path: str):
    """Template-free load: ``({path_str: CPU tensor}, meta)``, bf16
    leaves as ``torch.bfloat16``.  The scheduler's crash-recovery
    checkpoint is a flat dict whose keys depend on the serving state."""
    obj = _read(path)
    out = {key: _tensor(_decode_payload(rec), rec["dtype"],
                        tuple(rec["shape"]))
           for key, rec in obj["leaves"].items()}
    return out, obj["meta"]


def load_checkpoint(path: str, template: Any):
    """Restore into the structure of ``template`` (nested dicts of
    tensors or arrays; only their shapes are read).  Returns (tree,
    meta); a missing leaf raises ``KeyError``, another shape
    ``ValueError``."""
    obj = _read(path)
    leaves_in = obj["leaves"]
    out = []
    for p, leaf in tree_leaves_with_path(template):
        key = "/".join(str(k) for k in p)
        if key not in leaves_in:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = leaves_in[key]
        want = tuple(leaf.shape)
        if tuple(rec["shape"]) != want:
            raise ValueError(f"{key}: shape {rec['shape']} != {want}")
        out.append(_tensor(_decode_payload(rec), rec["dtype"], want))
    return tree_unflatten(template, out), obj["meta"]
