"""Sharding resolution shared by the LM launchers (the port of the sharding
half of ``repro.launch.steps``).

``named_shardings_for`` resolves a logical-axis tree against a mesh and
*demotes* any axis that does not divide its dimension (batch 1 cannot shard
over dp = 16; 8 KV heads cannot shard over model = 16). Demotions are
deterministic and recorded, in the reference's order and form: they are the
mesh-portability escape hatch, not a silent correctness hazard.

The trees are walked as ``jax.tree.map`` walks the reference's: dict keys
sorted, dataclass fields in order, lists in order. A tensor leaf pairs with
the logical tuple at its place (missing trailing axes replicated); any
other leaf (a cache's host-int ``length``, ``None``) passes through.
``abstract_params`` and ``abstract_cache`` give the trees as meta tensors,
so a production-size tree resolves with no storage behind it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import encdec as ED
from ..models import hybrid as HY
from ..models import stack as ST
from ..models.config import ArchConfig
from ..models.sharding import AxisRules, NamedSharding, axis_size

__all__ = ["named_shardings_for", "batch_logical", "abstract_params", "abstract_cache"]


def named_shardings_for(tensor_tree, logical_tree, mesh, rules: AxisRules,
                        demotions: Optional[list] = None):
    """(tensor tree, logical-axis tree) -> the tree with a ``NamedSharding``
    at each tensor leaf. ``demotions`` collects ``(shape, logical, physical,
    dim)`` for every axis dropped because it does not divide its dim."""

    def one(t, logical):
        axes = []
        shape = tuple(t.shape)
        for dim, ax in zip(shape, tuple(logical) + (None,) * (len(shape) - len(logical))):
            phys = rules.resolve(ax) if ax else None
            if phys is not None and dim % axis_size(mesh, phys) != 0:
                if demotions is not None:
                    demotions.append((shape, ax, phys, dim))
                phys = None
            axes.append(phys)
        return NamedSharding(mesh, tuple(axes))

    def walk(t, logical):
        if torch.is_tensor(t):
            return one(t, logical)
        if isinstance(t, dict):
            return {k: walk(t[k], logical[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(a, b) for a, b in zip(t, logical))
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: walk(getattr(t, f.name), getattr(logical, f.name))
                for f in dataclasses.fields(t)})
        return t

    return walk(tensor_tree, logical_tree)


def batch_logical(batch: dict) -> dict:
    """Logical axes for model input batches: batch dim -> dp, rest replicated."""
    return {k: ("dp",) + (None,) * (len(v.shape) - 1) for k, v in batch.items()}


def abstract_params(cfg: ArchConfig):
    """The fp32 parameter tree of ``cfg`` as meta tensors (shapes and dtypes,
    no storage)."""
    init = {"hybrid": HY.init_hybrid_params,
            "encdec": ED.init_encdec_params}.get(cfg.family, ST.init_stack_params)
    return init(torch.Generator(), cfg, device="meta")


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype):
    """The decode cache of ``cfg`` as meta tensors."""
    init = {"hybrid": HY.init_hybrid_cache,
            "encdec": ED.init_encdec_cache}.get(cfg.family, ST.init_stack_cache)
    return init(cfg, batch, max_seq, dtype, device="meta")
