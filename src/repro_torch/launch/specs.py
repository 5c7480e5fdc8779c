"""Abstract input specs per (architecture × input shape) (port of
``repro.launch.specs``).

Nothing is allocated: each input is a ``ShapeDtype`` record (the port's
``jax.ShapeDtypeStruct``) that the dry run turns into ``meta`` or fake
tensors (``ShapeDtype.empty``), and that documents what each step
consumes.

Shapes follow the assigned table: train_4k (4096×256), prefill_32k
(32768×32), decode_32k (32768×128, one new token), long_500k (524288×1).
For VLM the sequence is patches + text (image patch embeddings arrive
precomputed, in bf16); for audio the tokens carry a codebook axis.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.models.common import ModelConfig


class ShapeDtype(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype

    def empty(self, device="meta") -> torch.Tensor:
        """An uninitialized tensor of this shape and dtype (``meta``, or a
        fake tensor under ``FakeTensorMode``)."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


SDS = ShapeDtype

# federated-simulation granularity: clients per round in the SPMD step.
# 32 divides both the single-pod (16) and multi-pod (32) data extents.
TRAIN_CLIENTS = 32


def effective_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Arch variant actually run for this shape.

    long_500k requires sub-quadratic attention: SSM/hybrid archs run
    natively; attention archs run their sliding-window variant (window
    4096; h2o-danube-3-4b's native SWA already is one).
    """
    if shape.name == "long_500k" and cfg.family != "ssm" and cfg.sliding_window == 0:
        return cfg.replace(sliding_window=4096)
    return cfg


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Batch tree for the federated train step: (clients, per-client batch, seq)."""
    C = TRAIN_CLIENTS
    B, S = shape.global_batch, shape.seq_len
    if B % C:
        raise ValueError(f"global batch {B} is not a multiple of {C} clients")
    m = B // C
    if cfg.n_codebooks:
        return {"tokens": SDS((C, m, cfg.n_codebooks, S), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.vision_patches
        return {
            "tokens": SDS((C, m, S - p), torch.int32),
            "image_embeds": SDS((C, m, p, cfg.d_model), torch.bfloat16),
        }
    return {"tokens": SDS((C, m, S), torch.int32)}


def flat_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Batch tree for the centralized train / prefill step: (B, S)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.n_codebooks:
        return {"tokens": SDS((B, cfg.n_codebooks, S), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.vision_patches
        return {
            "tokens": SDS((B, S - p), torch.int32),
            "image_embeds": SDS((B, p, cfg.d_model), torch.bfloat16),
        }
    return {"tokens": SDS((B, S), torch.int32)}


def decode_token_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B = shape.global_batch
    if cfg.n_codebooks:
        return {"tokens": SDS((B, cfg.n_codebooks, 1), torch.int32)}
    return {"tokens": SDS((B, 1), torch.int32)}


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """Public entry: every model input for this (arch, shape) as ShapeDtype."""
    shape = SHAPES[shape_name]
    cfg = effective_config(cfg, shape)
    if shape.kind == "train":
        return train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return flat_batch_specs(cfg, shape)
    return decode_token_specs(cfg, shape)
