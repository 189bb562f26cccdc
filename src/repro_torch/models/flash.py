"""Flash attention for the port's prefill: the twin of the JAX package's
``models/flash.py`` forward pass.

The JAX module is flash attention in plain jnp with a ``custom_vjp``
backward, and ``repro.kernels.flash_attention`` is its Pallas twin.  Here
the forward pass is the hand-written kernel (``kernels.ops``: the CUDA
kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor).
The backward, a ``torch.autograd.Function`` with a kernel of its own,
comes with the training slice; until then an input that requires grad
raises.  Layout: q (B, Sq, H, D); k (B, Skv, Hkv, D); v (B, Skv, Hkv,
Dv), Dv = D except for MLA's expanded prefill (D 192, Dv 128)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int = 0, kv_len=None) -> torch.Tensor:
    """Grouped-GQA flash attention, forward only.

    ``q_offset`` and ``kv_len`` (prefill continuation, decode against a
    partly filled cache) are not used by any prefill of the contiguous
    serving path, and raise rather than being ignored."""
    if q_offset or kv_len is not None:
        raise NotImplementedError(
            "flash_attention: q_offset and kv_len are not ported (the "
            "monolithic prefill uses neither)")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the backward pass is not ported yet "
            "(forward only; run under torch.no_grad())")
    return ops.flash_attention(q, k, v, causal=causal, window=window)
