"""zamba2-7b [hybrid] — Mamba2 backbone + weight-shared attention blocks.
[arXiv:2411.15242]
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
The 81 layers are Mamba2 blocks; a single weight-shared attention+MLP
block (32 heads, d_ff=14336) is interleaved every 6 Mamba2 blocks,
following the Zamba2 shared-block design.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_every=6,
)

REDUCED = CONFIG.with_(
    name="zamba2-7b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, head_dim=64,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=64),
    shared_attn_every=2,
)
