"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.
[arXiv:2412.19437]
61L d_model=7168 128H d_ff=2048 (per expert) vocab=129280, MoE 256e top-8.
First 3 layers use a dense MLP (d_ff=18432); remaining 58 are MoE.
MLA: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128.
The decode KV cache stores the compressed latent (512+64 per token),
which is what makes 32k/500k decode shapes feasible.
"""
from repro_torch.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    citation="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                     # per routed expert
    vocab_size=129280,
    head_dim=128,
    use_mtp=True,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        experts_per_token=8,
        d_expert=2048,
        n_shared_experts=1,
        d_shared_expert=2048,
        n_dense_layers=3,
        dense_d_ff=18432,
    ),
)

REDUCED = CONFIG.with_(
    name="deepseek-v3-671b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=64,
    use_mtp=True,
    mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                  qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(n_experts=4, experts_per_token=2, d_expert=128,
                  n_shared_experts=1, d_shared_expert=128,
                  n_dense_layers=1, dense_d_ff=256),
)
