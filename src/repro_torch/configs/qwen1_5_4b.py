"""qwen1.5-4b [dense] — QKV bias, full MHA (kv=20).
[hf:Qwen/Qwen1.5-0.5B family, 4B variant]
40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
)

REDUCED = CONFIG.with_(
    name="qwen1.5-4b-reduced",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
    vocab_size=512, head_dim=64,
)
