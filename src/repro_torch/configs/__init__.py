"""Config registry: the 10 assigned architectures + input shapes (the JAX
package's ``repro.configs``, as data over the port's ModelConfig).

Every entry cites its source. The port runs every family: on the card in
``chip_smoke.py`` granite-3-2b, qwen2-vl-2b, musicgen-large and
xlstm-1.3b at full width and depth, qwen3-moe-235b-a22b at depth 1 and
zamba2-7b at depth 39 (full width); reduced variants on the CPU in the
tests.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ModelConfig

ARCH_IDS = [
    "granite_3_2b",
    "qwen2_vl_2b",
    "zamba2_7b",
    "h2o_danube_3_4b",
    "qwen3_moe_235b_a22b",
    "xlstm_1_3b",
    "llama4_maverick_400b_a17b",
    "starcoder2_15b",
    "musicgen_large",
    "qwen3_8b",
]

# canonical dashed ids (CLI --arch) -> module names
DASHED = {a.replace("_", "-"): a for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    name = DASHED.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce_config(cfg: ModelConfig, seq_friendly: bool = True) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4 experts."""
    kw = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab=512,
        head_dim=0,
        ssm_chunk=16,
        moe_group=16,
    )
    if cfg.mrope_sections:
        kw["mrope_sections"] = (16, 8, 8)  # hd=64 -> hd/2=32 channels
        kw["vision_patches"] = 8
    if cfg.sliding_window:
        kw["sliding_window"] = 8
    if cfg.is_moe_arch:
        kw["n_experts"] = 4
        kw["top_k"] = min(cfg.top_k, 2)
        kw["d_ff"] = 128
        if cfg.moe_interleave > 1:
            kw["n_layers"] = 2  # one (dense, moe) pair
    if cfg.family == "hybrid":
        kw["attn_every"] = 1
        kw["ssm_heads"] = 8
        kw["ssm_state"] = 16
    if cfg.family == "ssm":
        kw["slstm_every"] = 2
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4
    if cfg.n_codebooks:
        kw["vocab"] = 64
    return cfg.replace(**kw)
