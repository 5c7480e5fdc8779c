"""Model zoo of the port: the dense, MoE (``moe``), VLM and audio
transformers (``common``, ``transformer``, ``zoo``); the SSM and hybrid
families (``repro.models.ssm``) are a later port slice."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
