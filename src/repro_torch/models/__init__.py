"""Model zoo of the port: the dense transformer (``common``, ``transformer``,
``zoo``); the other families are a later port slice."""
from repro_torch.models.common import ModelConfig
from repro_torch.models.zoo import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model"]
