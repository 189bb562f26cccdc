"""Meta-tensor input stand-ins for every (arch x input-shape) pair: the
twin of the JAX package's ``launch/specs.py``.  Where the reference
returns ``jax.ShapeDtypeStruct``s from ``jax.eval_shape``, the port
returns tensors on the meta device, which hold a shape and a dtype and
no data, and which the dry-run (``launch.dryrun``) runs its steps on.
Token ids are int32, as the reference's."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, ShapeSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def variant_for_shape(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """long_500k needs sub-quadratic attention: SSM/hybrid run natively;
    quadratic-attention archs get the sliding-window variant (window 4096,
    ring-buffer cache), as in the reference."""
    if (shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm")
            and not cfg.sliding_window):
        return cfg.with_(sliding_window=4096)
    return cfg


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model inputs for a full-sequence step (train / prefill)."""
    B, S = shape.global_batch, shape.seq_len
    act = L.dtype_of(cfg.activation_dtype)
    if cfg.family == "vlm":
        s_text = S - cfg.n_patches
        return {"tokens": _spec((B, s_text), torch.int32),
                "patch_embeds": _spec((B, cfg.n_patches, cfg.d_model), act)}
    if cfg.family == "audio":
        return {"tokens": _spec((B, S), torch.int32),
                "audio_frames": _spec((B, cfg.n_audio_frames, cfg.d_model),
                                      act)}
    return {"tokens": _spec((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Inputs for serve_step: one new token against a seq_len KV cache
    (``transformer.init_cache`` on the meta device)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _spec((B, 1), torch.int32),
            "pos": _spec((), torch.int32),
            "cache": T.init_cache(cfg, B, S, device=META)}


def params_specs(cfg: ModelConfig, max_seq: int) -> dict:
    """The params tree as meta tensors (``transformer.param_shapes``)."""
    return T.param_shapes(cfg, max_seq=max_seq)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """All meta inputs for the step this shape builds."""
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return batch_specs(cfg, shape)
