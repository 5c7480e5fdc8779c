"""zamba2-7b — hybrid Mamba2 backbone + shared attention block. [arXiv:2411.15242]

81 Mamba2 layers; ONE shared transformer block (weights reused) applied after
every 6th Mamba2 layer (13 applications + 3 tail Mamba2 layers).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,  # shared attention block is MHA
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_heads=112,  # d_inner 7168 / head dim 64
    ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242",
)
