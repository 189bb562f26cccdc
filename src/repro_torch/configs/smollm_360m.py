"""smollm-360m [dense] — llama-arch small model.
[hf:HuggingFaceTB/SmolLM-135M family, 360M variant]
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    citation="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
)

REDUCED = CONFIG.with_(
    name="smollm-360m-reduced",
    n_layers=2, d_model=240, n_heads=3, n_kv_heads=1, d_ff=640,
    vocab_size=512, head_dim=80,
)
