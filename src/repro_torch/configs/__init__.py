"""Architecture registry: ``--arch <id>`` resolves here (the port's copy of
``repro.configs``, the same published numbers and the same ``reduced()``).
``configs.common.input_specs`` gives a shape cell's inputs as meta tensors.
"""
from __future__ import annotations

import importlib

from ..models.config import SHAPES, ArchConfig

_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "starcoder2-15b": "starcoder2_15b",
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-tiny": "whisper_tiny",
    "chameleon-34b": "chameleon_34b",
    "mamba2-1.3b": "mamba2_1_3b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, *, reduced: bool = False) -> ArchConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.reduced() if reduced else mod.CONFIG


def all_configs(reduced: bool = False):
    return {a: get_config(a, reduced=reduced) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "get_config", "all_configs", "SHAPES", "ArchConfig"]
