"""Confidence gate on Hopper: the ctypes wrapper of ``csrc/conf_gate.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/conf_gate.py``
(``confidence_gate_kernel``): one streaming pass over ``(B, V)`` logits
that emits max_prob, entropy, margin and the first-index argmax.  The
source file carries the note on what bounds the kernel and how its
design answers it; ``plan`` reports the cut it takes at given sizes."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def confidence_gate_kernel(logits):
    """logits: (B, V) float32/bfloat16/float16 on CUDA, V >= 2 ->
    dict(max_prob, entropy, margin: (B,) float32; argmax: (B,) int32).
    B = 0 returns empty tensors without a launch.  Launches on the
    current stream."""
    global launches
    if not logits.is_cuda:
        raise ValueError("confidence_gate: logits must be a CUDA tensor")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"confidence_gate: logits dtype {logits.dtype} not "
                         f"in {list(_DTYPES)}")
    if logits.dim() != 2 or logits.shape[1] < 2:
        raise ValueError(f"confidence_gate: logits must be (B, V>=2), got "
                         f"{tuple(logits.shape)}")
    x = logits.contiguous()
    B, V = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    mp, ent, mar = (torch.empty(B, **f32) for _ in range(3))
    am = torch.empty(B, dtype=torch.int32, device=x.device)
    if B == 0:                      # an empty batch: nothing to launch
        return {"max_prob": mp, "entropy": ent, "margin": mar, "argmax": am}
    fn = build.function("conf_gate", "confidence_gate", _ARGTYPES)
    err = fn(x.data_ptr(), mp.data_ptr(), ent.data_ptr(), mar.data_ptr(),
             am.data_ptr(), B, V, _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"confidence_gate launch failed: cudaError {err}")
    launches += 1
    return {"max_prob": mp, "entropy": ent, "margin": mar, "argmax": am}


_LAYOUTS = ("narrow", "rows", "cluster")


def plan(B, V, dtype) -> dict:
    """How the kernel cuts a (B, V) call of this dtype: ``layout``
    ("narrow": ``G`` lanes a row, many rows a CTA; "rows": one CTA a row;
    "cluster": ``C`` CTAs a row in a thread block cluster, each reducing
    ``slice`` elements), ``threads`` a CTA, ``ctas`` in the grid and
    ``K`` 16-byte loads a thread has in flight.  Chosen from the sizes
    and the SM count alone; needs the card."""
    out = (ctypes.c_int * 7)()
    fn = build.function("conf_gate", "confidence_gate_plan",
                        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(B, V, _DTYPES[dtype], out)
    if err:
        raise ValueError(f"confidence_gate: sizes ({B}, {V}) not taken "
                         f"(cudaError {err})")
    return dict(layout=_LAYOUTS[out[0]], G=out[1], C=out[2],
                threads=out[3], ctas=out[4], slice=out[5], K=out[6])


def work(B: int, V: int, dtype) -> dict:
    """The least work of one launch: the logits read once and four fp32
    results a row written; five operations a logit on the CUDA cores."""
    item = torch.empty((), dtype=dtype).element_size()
    return dict(bytes=B * V * item + 16 * B, flops=5 * B * V,
                tensor_cores=False)
