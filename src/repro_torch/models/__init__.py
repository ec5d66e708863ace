"""The model stack of the PyTorch port: the configuration (every family),
and the dense decoder's layers and model (``build_model``), with
``params_from_jax`` to carry a reference param tree over."""

from .config import ModelConfig, round_up
from .convert import params_from_jax
from .model import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model", "params_from_jax",
           "round_up"]
