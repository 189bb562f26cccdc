"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution; vision encoder STUB.
[arXiv:2409.12191]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The ViT vision encoder + projector is a stub per the assignment:
input_specs() provides precomputed patch embeddings (batch, n_patches,
d_model) which the model interleaves ahead of the text tokens.  M-RoPE
splits each head_dim/2 rotary space into (temporal, height, width)
sections (16, 24, 24).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    citation="arXiv:2409.12191",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    n_patches=256,                 # default image budget per request
    tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    name="qwen2-vl-2b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, head_dim=64, n_patches=16,
    mrope_sections=(8, 12, 12),
)
