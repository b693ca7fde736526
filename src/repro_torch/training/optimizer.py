"""AdamW with warmup-cosine schedule (the port of
``repro.training.optimizer``), over the leaves of a parameter dict.

Moments are fp32; params are fp32 masters (model code casts to bf16 at use
sites). The arithmetic is the reference's: the schedule and the bias
corrections in fp32 over an int32 step, the clip by the fp32 global norm
(per leaf, then across leaves), weight decay on every leaf. The update is
in place: one ``torch._foreach_*`` call per operation over all leaves,
under ``torch.no_grad()``, where the reference builds new arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from ..models.sharding import at_site

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update",
           "lr_at", "global_norm", "clip_by_global_norm", "tree_leaves", "tree_unflatten",
           "tree_map"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass
class OptState:
    mu: Any
    nu: Any
    step: torch.Tensor    # int32, 0-d, on the parameters' device


def tree_leaves(tree):
    """The leaves of a nested dict in the reference's order (keys sorted,
    as ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves``'s order)."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)
    return build(like)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> OptState:
    device = tree_leaves(params)[0].device
    return OptState(
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in fp32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares, as
    ``torch.sum(torch.square(x))`` (a pairwise sum on both devices: on the
    CPU, ``torch.linalg.vector_norm`` and ``torch._foreach_norm`` of an
    82 M-element fp32 leaf are ~1 % off). Over a mesh a leaf's sum is
    all-reduced over its shards, so the norm is the global one, a plain
    tensor equal on every rank."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    sums = at_site("grad_norm", lambda *s: [x.full_tensor() if isinstance(x, DTensor) else x
                                            for x in s], *sums)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm):
    """Scales every leaf of ``grads`` IN PLACE by min(1, max_norm / norm);
    returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    with torch.no_grad():
        torch._foreach_mul_(tree_leaves(grads), scale)
    return grads, norm


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig):
    """One AdamW step, in place: the parameters and ``state`` are updated
    and returned as (params, state, {"lr", "grad_norm"}). ``grads`` (fp32,
    the parameters' structure) is consumed: it is clipped in place."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        state.step += 1
        lr = lr_at(state.step, cfg)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1.0 - torch.pow(b1, state.step.float())
        bc2 = 1.0 - torch.pow(b2, state.step.float())
        P, G = tree_leaves(params), tree_leaves(grads)
        M, V = tree_leaves(state.mu), tree_leaves(state.nu)
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        torch._foreach_mul_(M, b1)
        torch._foreach_add_(M, G, alpha=1 - b1)
        torch._foreach_mul_(V, b2)
        torch._foreach_addcmul_(V, G, G, value=1 - b2)
        # p -= lr (mhat / (sqrt(vhat) + eps) + wd p)
        denom = torch._foreach_div(V, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(M, bc1)
        torch._foreach_div_(upd, denom)
        del denom
        torch._foreach_add_(upd, P, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(P, upd)
    return params, state, {"lr": lr, "grad_norm": gnorm}
