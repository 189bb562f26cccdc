"""whisper-tiny [audio] — encoder-decoder, conv frontend (STUB).
[arXiv:2212.04356]
4L (encoder) + 4L (decoder) d_model=384 6H d_ff=1536 vocab=51865.
The mel-spectrogram + conv feature extractor is a stub: callers pass
precomputed frame embeddings of shape (batch, 1500, 384).  Sinusoidal
encoder positions and learned decoder positions, no rotary embedding;
pre-LN LayerNorm and the biased GELU MLP (``models/transformer.py``).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    citation="arXiv:2212.04356",
    n_layers=4,                    # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    qkv_bias=True,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    n_audio_frames=1500,
)

REDUCED = CONFIG.with_(
    name="whisper-tiny-reduced",
    n_layers=2, n_encoder_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=64, n_audio_frames=96,
)
