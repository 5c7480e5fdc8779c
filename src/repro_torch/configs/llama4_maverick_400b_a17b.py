"""llama4-maverick-400b-a17b — MoE 128e top-1 + shared expert, alternating
dense/MoE layers, early fusion. [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=128,
    top_k=1,
    moe_interleave=2,  # alternating dense / MoE
    shared_expert=True,
    capacity_factor=2.0,  # top-1 routing needs headroom
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
