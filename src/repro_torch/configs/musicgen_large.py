"""musicgen-large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec audio codec is stubbed per the carve-out: input_specs() provides
codebook token ids directly; this is the 4-codebook language decoder.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    n_codebooks=4,
    source="arXiv:2306.05284",
)
