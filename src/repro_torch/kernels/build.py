"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exports a plain C function, so a build is one
``nvcc -shared`` call with no PyTorch headers (seconds, not minutes).
The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of its source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  ``build`` starts one
nvcc per source, all at once; ``function`` builds on first use.  Nothing
here runs at import: the CPU tests import every module of the port."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("paged_decode_attention", "conf_gate", "flash_attention",
           "decode_attention", "ssm_chunk_scan", "int8_quant")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_functions: dict = {}            # "library:symbol" -> loaded C function


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns, per name, the
    seconds its build took (0.0 when it was already built) and what
    ptxas reported (registers, shared memory, spills).  Raises with
    nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)          # atomic: a reader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def rows_aligned(t) -> bool:
    """Every row of ``t``'s last axis starts on a 16-byte boundary (a
    2-byte type: data_ptr % 16 == 0 and strides % 8 == 0), as the
    tensor-core kernels' 16-byte cp.async copies need."""
    return t.data_ptr() % 16 == 0 and all(x % 8 == 0
                                          for x in t.stride()[:-1])


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C function ``symbol`` of library ``name`` (built on first
    use), with its argument and result types declared (by default an
    int: the cudaError_t of a launch)."""
    key = f"{name}:{symbol}"
    fn = _functions.get(key)
    if fn is None:
        lib = library_path(name)
        if not lib.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _functions[key] = fn
    return fn
