"""qwen2-vl-2b — VLM backbone with M-RoPE. [arXiv:2409.12191]

The ViT vision frontend is stubbed per the carve-out: input_specs() provides
precomputed patch embeddings; this config is the language decoder that
consumes them (dynamic-resolution patches -> (t,h,w) M-RoPE position ids).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    # head_dim = 1536/12 = 128 -> 64 rotary channels split (t,h,w)=(16,24,24)
    mrope_sections=(16, 24, 24),
    vision_patches=1024,
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191",
)
