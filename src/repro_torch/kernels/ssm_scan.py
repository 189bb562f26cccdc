"""Mamba2 SSD chunked scan on Hopper: the ctypes wrapper of
``csrc/ssm_chunk_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py``
(``ssm_chunk_scan_kernel``), the kernel form of
``repro/models/ssm.py::ssd_chunked`` that every Mamba2 prefill runs: the
intra-chunk quadratic term with its decay matrix plus the fp32 state
carried across chunks.  Unlike the Pallas kernel, which writes y in x's
type, this one returns fp32 y as ``ssd_chunked`` does, so the model adds
``D * x`` in fp32 before its cast.  bfloat16 x/B/C take the
tensor-core design (mma.sync, cp.async tiles), float32 ones the
CUDA-core one (exact fp32 products).  The source file carries the note
on what bounds the kernel and how each design answers it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0            # kernel launches; read and reset through ``ops``

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 9
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])
MAX_CHUNK = 1024
MAX_WIDTH = 128


def ssm_chunk_scan_kernel(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """x: (B, S, H, P) float32 or bfloat16 on CUDA; dt: (B, S, H) float32
    (post-softplus); A: (H,) float32 (negative); Bm, Cm: (B, S, G, N) of
    x's type, G dividing H: head h reads group ``h // (H // G)`` (G == H
    is the reference's repeated layout).  x, Bm and Cm are read through
    their strides and need only a contiguous last axis.  P and N are
    multiples of 16 up to 128; ``Lc = min(chunk, S)`` is at most 1024 and
    must divide S, as ``ssd_chunked`` asserts.  bfloat16 x/B/C also need
    16-byte aligned rows (data_ptr % 16 == 0, strides % 8 == 0), as the
    conv output's views have; others raise.  Returns (y (B, S, H, P),
    final state (B, H, P, N)), both float32.  Launches on the current
    stream."""
    global launches
    if not all(t.is_cuda and t.device == x.device for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssm_chunk_scan: x, dt, A, Bm and Cm must be CUDA "
                         "tensors on one device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"ssm_chunk_scan: x/Bm/Cm must share one of "
                         f"{list(_DTYPES)}, got {x.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssm_chunk_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if x.dim() != 4 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"ssm_chunk_scan: x {tuple(x.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} are not "
                         "(B, S, H, P) and two (B, S, G, N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if Bm.shape[:2] != (B, S) or tuple(dt.shape) != (B, S, H) \
            or tuple(A.shape) != (H,) or G < 1 or H % G:
        raise ValueError(f"ssm_chunk_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if P % 16 or not 16 <= P <= MAX_WIDTH or N % 16 \
            or not 16 <= N <= MAX_WIDTH:
        raise ValueError(f"ssm_chunk_scan: head_dim {P} and d_state {N} "
                         f"must be multiples of 16 up to {MAX_WIDTH}")
    Lc = min(chunk, S)
    if Lc < 1 or Lc > MAX_CHUNK or S % Lc:
        raise ValueError(f"ssm_chunk_scan: length {S} is not a multiple of "
                         f"the chunk {Lc} (at most {MAX_CHUNK})")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssm_chunk_scan: the last axis of x, Bm and Cm "
                         "must be contiguous")
    if x.dtype == torch.bfloat16 and not all(
            build.rows_aligned(t) for t in (x, Bm, Cm)):
        raise ValueError("ssm_chunk_scan: bfloat16 x, Bm and Cm need "
                         "16-byte aligned rows (data_ptr % 16 == 0, "
                         "strides % 8 == 0)")
    dt, A = dt.contiguous(), A.contiguous()
    nc = S // Lc
    n_work = build.function(
        "ssm_chunk_scan", "ssm_chunk_scan_workspace", [ctypes.c_int] * 5,
        restype=ctypes.c_size_t)(B, H, nc, P, N)
    work = torch.empty(n_work, dtype=torch.float32, device=x.device)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.function("ssm_chunk_scan", "ssm_chunk_scan", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), h.data_ptr(), work.data_ptr(),
             *x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3],
             B, S, H, G, P, N, Lc, _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssm_chunk_scan launch failed: cudaError {err}")
    launches += 1
    return y, h


def scan_flops(B: int, S: int, H: int, P: int, N: int, Lc: int) -> float:
    """Operations the SSD scan needs: per (batch, head) and chunk the
    causal pairs' C.B and W.x products, the chunk state, the carried
    state's C.h for every chunk after the first, and the scan's update."""
    nc = S // Lc
    pairs = Lc * (Lc + 1) // 2
    per_bh = (nc * (2 * pairs * (N + P) + 2 * Lc * P * N + 2 * P * N)
              + (nc - 1) * 2 * Lc * P * N)
    return float(B * H * per_bh)


def work(B: int, S: int, H: int, P: int, N: int, G: int, chunk: int,
         dtype) -> dict:
    """The least work of one launch: x, B and C read in their type, dt
    and A in fp32, y and the final state written in fp32, once each;
    ``scan_flops`` at chunks of min(chunk, S), on the tensor cores for
    bfloat16."""
    item = torch.empty((), dtype=dtype).element_size()
    n_bytes = (item * (B * S * H * P + 2 * B * S * G * N)
               + 4 * (B * S * H + H + B * S * H * P + B * H * P * N))
    return dict(bytes=n_bytes,
                flops=scan_flops(B, S, H, P, N, min(chunk, S)),
                tensor_cores=dtype == torch.bfloat16)
