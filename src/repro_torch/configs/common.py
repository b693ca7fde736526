"""``input_specs``: the model inputs of one shape cell as meta tensors (the
port of ``repro.configs.common``): the reference's shapes in torch dtypes,
placeable and shardable, with no storage behind them."""
from __future__ import annotations

import torch

from ..models.config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["input_specs", "SHAPES"]


def input_specs(cfg: ArchConfig, shape_name: str, *, shape: ShapeSpec = None) -> dict:
    """Model inputs for one shape cell, as meta tensors (``shape`` in place
    of ``SHAPES[shape_name]``)."""
    spec = shape or SHAPES[shape_name]
    B, T = spec.global_batch, spec.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    if spec.kind == "train":
        out["tokens"] = meta((B, T), torch.int32)
        out["targets"] = meta((B, T), torch.int32)
        out["mask"] = meta((B, T), torch.float32)
    elif spec.kind == "prefill":
        out["tokens"] = meta((B, T), torch.int32)
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = meta((B, 1), torch.int32)
    if cfg.family == "encdec" and spec.kind != "decode":
        out["frames"] = meta((B, cfg.enc_frames, cfg.d_model), cfg.activation_dtype)
    return out
