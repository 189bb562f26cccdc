"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8.
[hf:Qwen/Qwen3-30B-A3B]
48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936,
MoE 128e top-8.  Qwen3 uses head_dim=128 with QK-norm; d_ff is the
per-expert (moe) intermediate size.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # per-expert intermediate size
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    moe=MoEConfig(
        n_experts=128,
        experts_per_token=8,
        d_expert=768,
    ),
)

REDUCED = CONFIG.with_(
    name="qwen3-moe-30b-a3b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=64,
    moe=MoEConfig(n_experts=4, experts_per_token=2, d_expert=128),
)
