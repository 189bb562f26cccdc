"""Row-wise absmax int8 quantization on Hopper: the ctypes wrapper of
``csrc/int8_quant.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/int8_quant.py``
(``int8_quantize_kernel``): ``(N, D)`` -> int8 ``(N, D)`` plus one fp32
scale per row, bit for bit the plain version's ``q``.  The port runs it
where ``CascadeConfig.quantize_payload`` says the reference's ledger
does: on the escalated payload of a cascade run.  Unlike the Pallas
kernel, it takes any N (no multiple of a row block) and any D.  The
source file carries the note on what bounds the kernel and how its
design answers it; ``plan`` reports the cut it takes at given sizes."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def int8_quantize_kernel(x):
    """x: (N, D) float32/bfloat16/float16 on CUDA -> (q int8 (N, D),
    scale float32 (N,)).  N = 0 returns empty tensors without a launch.
    Launches on the current stream."""
    global launches
    if not x.is_cuda:
        raise ValueError("int8_quantize: x must be a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_quantize: dtype {x.dtype} not in "
                         f"{list(_DTYPES)}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"int8_quantize: x must be (N, D>=1), got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    N, D = x.shape
    q = torch.empty((N, D), dtype=torch.int8, device=x.device)
    scale = torch.empty((N,), dtype=torch.float32, device=x.device)
    if N == 0:
        return q, scale
    fn = build.function("int8_quant", "int8_quantize", _ARGTYPES)
    err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), N, D,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_quantize launch failed: cudaError {err}")
    launches += 1
    return q, scale


_PATHS = ("warp_rows", "cta_rows", "streaming")


def plan(N, D, dtype, aligned=True) -> dict:
    """How the kernel cuts an (N, D) call of this dtype: ``path``
    ("warp_rows": a warp a row, ``rows`` rows a CTA; "cta_rows": a CTA a
    row; both hold the row in registers, ``R`` slots a thread;
    "streaming": a CTA a row in two passes, ``R`` slots a thread in
    flight), ``W`` values a slot (a 16-byte vector, or 1 on the scalar
    path: D not a multiple of a vector, or ``aligned`` False), ``P``
    threads a row, ``threads`` a CTA and ``ctas`` in the grid.  Chosen
    from the sizes alone."""
    out = (ctypes.c_int * 7)()
    fn = build.function("int8_quant", "int8_quantize_plan",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(N, D, _DTYPES[dtype], int(aligned), out)
    if err:
        raise ValueError(f"int8_quantize: sizes ({N}, {D}) not taken "
                         f"(cudaError {err})")
    return dict(path=_PATHS[out[0]], W=out[1], R=out[2], P=out[3],
                rows=out[4], threads=out[5], ctas=out[6])


def work(N: int, D: int, dtype) -> dict:
    """The least work of one launch: x read once, the int8 rows and the
    fp32 scales written; five operations an element on the CUDA cores."""
    item = torch.empty((), dtype=dtype).element_size()
    return dict(bytes=N * D * (item + 1) + 4 * N, flops=5 * N * D,
                tensor_cores=False)
