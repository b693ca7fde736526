"""Carry the reference's parameters across: its pytree (nested dicts of
arrays, as ``repro.models.Model.init`` returns them) becomes the port's
parameter dict, leaf for leaf. The two packages share names and layouts, so
this is a copy plus a check that every name and shape is where the port's
own init puts it (drawn on the meta device: no memory, no values)."""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from . import encdec as ED
from . import hybrid as HY
from . import stack as ST
from .config import ArchConfig

__all__ = ["params_from_jax"]


def _layout(cfg: ArchConfig):
    kw = dict(device="meta")
    if cfg.family == "hybrid":
        return HY.init_hybrid_params(None, cfg, **kw)
    if cfg.family == "encdec":
        return ED.init_encdec_params(None, cfg, **kw)
    return ST.init_stack_params(None, cfg, **kw)


def _carry(tree, want, path, device):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params{path}: keys {got}, expected {sorted(want)}")
        return {k: _carry(tree[k], want[k], f"{path}[{k!r}]", device) for k in want}
    leaf = np.asarray(tree)
    if leaf.shape != tuple(want.shape) or leaf.dtype != np.float32:
        raise ValueError(f"params{path}: {leaf.dtype} {leaf.shape}, expected float32 "
                         f"{tuple(want.shape)}")
    return torch.from_numpy(np.array(leaf)).to(device)


def params_from_jax(tree, cfg: ArchConfig, *, device=None):
    """The reference's parameter pytree (leaves anything ``np.asarray``
    takes) as the port's parameter dict on ``device`` (None -> cuda)."""
    return _carry(tree, _layout(cfg), "", resolve_device(device))
