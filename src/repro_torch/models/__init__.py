"""Model zoo of the port: the dense, MoE (``moe``), VLM and audio
transformers (``common``, ``transformer``, ``zoo``), and the SSM (xLSTM)
and hybrid (Mamba-2 + shared attention) families (``ssm``)."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
