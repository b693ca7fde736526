"""The LM stack of the port: the five model families (dense, MoE, SSM,
hybrid, encoder-decoder) as plain PyTorch functions over parameter dicts
with the reference's names and layouts."""
from .config import SHAPES, ArchConfig, ShapeSpec
from .convert import params_from_jax
from .model import Model

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "Model", "params_from_jax"]
