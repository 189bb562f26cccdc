"""granite-20b [dense] — llama-arch code model, MQA.
[arXiv:2405.04324]
52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    citation="arXiv:2405.04324",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp_type="gelu",
)

REDUCED = CONFIG.with_(
    name="granite-20b-reduced",
    n_layers=2, d_model=384, n_heads=6, n_kv_heads=1, d_ff=1024,
    vocab_size=512, head_dim=64,
)
