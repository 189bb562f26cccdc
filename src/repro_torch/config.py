"""Configuration system for the PyTorch port: a copy of the JAX package's
``config`` module, kept apart so that the port imports nothing of it.

Every assigned architecture is described by a :class:`ModelConfig`; input
shapes by :class:`ShapeSpec`.  Configs live in ``repro_torch.configs.<arch>`` as
module-level ``CONFIG`` (full, exact numbers from the assignment table) and
``REDUCED`` (smoke-test variant: <=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


# --------------------------------------------------------------------------
# Block types understood by the model builder (repro_torch.models.transformer
# builds "attn", "attn_moe", zamba2's mamba2 + shared attention, xLSTM's
# mlstm + slstm and whisper's encoder and cross-attending decoder blocks).
#   attn      - GQA/MQA/MLA self-attention + dense MLP
#   attn_moe  - self-attention + mixture-of-experts MLP
#   mamba2    - Mamba2 selective-state-space block
#   mlstm     - xLSTM matrix-memory block
#   slstm     - xLSTM scalar-memory block
# Hybrids (zamba2) additionally use `shared_attn_every` to interleave a
# weight-shared attention block between SSM blocks.
# --------------------------------------------------------------------------

VALID_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared_experts: int = 0
    d_shared_expert: int = 0       # hidden dim of the shared expert(s)
    router_aux_loss: float = 0.01  # load-balance loss coefficient
    # number of leading layers that use a dense MLP instead of MoE
    n_dense_layers: int = 0
    dense_d_ff: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention [arXiv:2412.19437]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block hyper-parameters [arXiv:2405.21060 via zamba2 2411.15242]."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256               # chunked-scan chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyper-parameters [arXiv:2405.04517]."""
    slstm_every: int = 8           # every k-th block is an sLSTM block (7:1 ratio)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    d_conv: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # one of VALID_FAMILIES
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False          # Qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10_000.0
    mrope: bool = False            # Qwen2-VL multimodal RoPE
    mrope_sections: tuple = (16, 24, 24)   # (t, h, w) split of head_dim/2
    tie_embeddings: bool = False
    mlp_type: str = "swiglu"       # "swiglu" | "gelu" (GPT-BigCode/whisper)
    norm_eps: float = 1e-6
    # sliding-window attention (enables long_500k on quadratic archs)
    sliding_window: int = 0        # 0 -> full attention
    # family-specific sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # DeepSeek-V3 multi-token prediction head [arXiv:2412.19437 §2.2]
    use_mtp: bool = False
    mtp_weight: float = 0.3
    # hybrid (zamba2): apply a weight-shared attention block every k SSM blocks
    shared_attn_every: int = 0
    # audio (whisper): encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # precomputed mel/conv frames (frontend stub)
    # vlm (qwen2-vl): number of precomputed patch embeddings per request
    n_patches: int = 0
    # dtype policy
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def __post_init__(self):
        if self.family not in VALID_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """The parameter count from the init's shapes; active_only
        counts only the routed experts a token uses (for MoE
        MODEL_FLOPS)."""
        from repro_torch.models.counting import count_params
        return count_params(self, active_only=active_only)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'

    def __post_init__(self):
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(self.kind)


INPUT_SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}

ARCH_IDS = (
    "smollm-360m",
    "qwen3-moe-30b-a3b",
    "zamba2-7b",
    "granite-34b",
    "deepseek-v3-671b",
    "whisper-tiny",
    "xlstm-1.3b",
    "qwen1.5-4b",
    "qwen2-vl-2b",
    "granite-20b",
)


def _config_module(arch: str):
    import importlib
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")


def get_config(arch: str) -> ModelConfig:
    """Load the full config for an assigned architecture id."""
    return _config_module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _config_module(arch).REDUCED


def side_input(cfg: ModelConfig) -> Optional[tuple]:
    """The family's side input, a (B, n, d_model) tensor ahead of the
    tokens, as (batch key, n): whisper's encoder frames, qwen2-vl's patch
    embeddings; None for the families without one."""
    return {"audio": ("audio_frames", cfg.n_audio_frames),
            "vlm": ("patch_embeds", cfg.n_patches)}.get(cfg.family)


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """Whether (arch, shape) is a supported pair (see DESIGN.md §6)."""
    if shape.name == "long_500k":
        # whisper's decoder is anchored to a 1500-frame encoder; a 500k
        # self-attention decode cache contradicts the architecture.
        return not cfg.is_encoder_decoder
    return True
