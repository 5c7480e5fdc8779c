"""qwen3-moe-235b-a22b — MoE, 128 experts top-8, every layer MoE.
[hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,  # per-expert intermediate dim
    vocab=151936,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    moe_interleave=1,
    capacity_factor=1.25,
    source="hf:Qwen/Qwen3-30B-A3B",
)
