"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, no separate FFN (d_ff=0).
[arXiv:2405.04517]
48L d_model=2048 4H vocab=50304.  Blocks are mLSTM (matrix memory,
proj_factor=2) with every 8th block an sLSTM (scalar memory,
proj_factor=4/3), the paper's ~7:1 ratio.
"""
from repro_torch.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    citation="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                        # blocks carry their own up/down proj
    vocab_size=50304,
    head_dim=512,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.3333, d_conv=4),
)

REDUCED = CONFIG.with_(
    name="xlstm-1.3b-reduced",
    n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_ff=0,
    vocab_size=512, head_dim=128,
    xlstm=XLSTMConfig(slstm_every=2, proj_factor_mlstm=2.0,
                      proj_factor_slstm=1.3333, d_conv=4),
)
