"""starcoder2-15b — dense GQA with RoPE. [arXiv:2402.19173]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    rope_theta=100_000.0,
    gated_mlp=False,  # starcoder2 uses a plain GELU MLP
    source="arXiv:2402.19173",
)
