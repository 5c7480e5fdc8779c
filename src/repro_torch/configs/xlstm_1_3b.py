"""xlstm-1.3b — sLSTM + mLSTM blocks at a 1:7 ratio. [arXiv:2405.04517]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,  # xLSTM blocks carry their own projections; no separate FFN
    vocab=50304,
    ssm_expand=2,
    slstm_every=8,  # one sLSTM per 8 blocks (7 mLSTM + 1 sLSTM)
    source="arXiv:2405.04517",
)
