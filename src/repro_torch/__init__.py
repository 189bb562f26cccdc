"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the JAX package path for path; imports ``torch`` and numpy and
nothing of JAX or of ``repro``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise rather than
fall back to the CPU (``resolve_device``)."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default) needs a
    visible GPU: without one this raises instead of quietly running on
    the CPU, which only an explicit ``device="cpu"`` selects.  ``meta``
    (shapes and dtypes, no data) is the dry-run's (``launch.dryrun``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is visible; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
