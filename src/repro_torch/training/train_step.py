"""Training step: masked LM cross-entropy + AdamW, with optional microbatch
gradient accumulation and an int8 compressed all-reduce for the
data-parallel gradient exchange (the port of ``repro.training.train_step``).

Gradients are ``torch.autograd`` over the fp32 master leaves, through the
plain torch ops of ``repro_torch.models`` (each layer under activation
checkpointing as ``cfg.remat`` says). A step updates the state IN PLACE:
the reference's ``donate`` has no counterpart, and a snapshot (a
checkpoint) copies the leaves before the next step overwrites them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.model import Model
from ..models.sharding import at_site, shard_hint
from .optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state, tree_leaves,
                        tree_unflatten)

__all__ = ["TrainState", "make_train_step", "loss_fn", "loss_and_grads", "init_train_state",
           "compressed_psum", "make_dp_train_step"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    step: torch.Tensor    # int32, 0-d


def init_train_state(model: Model, generator: torch.Generator) -> TrainState:
    """Random fp32 masters from ``generator`` (on the model's device), zero
    moments, step 0."""
    params = model.init(generator)
    return TrainState(params=params, opt=init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def loss_fn(model: Model, params, batch, *, aux_weight: float = 0.01):
    """Masked mean of the fp32 token NLL (logsumexp minus the gold logit),
    plus ``aux_weight`` times the MoE load-balancing loss."""
    logits, aux = model.forward_train(params, batch)
    logits = logits.float()
    targets = torch.as_tensor(batch["targets"], device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    # over a mesh logits hold vocab over tp: the gathered gold logit is a
    # masked partial sum there, reduced at once (before it meets logz)
    gold = shard_hint(torch.gather(logits, -1, targets[..., None]), "dp", None, None,
                      site="gold_logit")[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32, device=logits.device)
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = nll.numel()
    loss = torch.sum(nll) / denom
    if aux is not None:
        loss = loss + aux_weight * aux
    return loss


def loss_and_grads(model: Model, params, batch):
    """(loss, grads): the loss detached and its fp32 gradient with respect
    to every parameter leaf, as a dict of the parameters' structure (the
    reference's ``jax.value_and_grad`` of ``loss_fn``). The graph is
    recorded on aliases of the leaves (same storage): the masters
    themselves keep ``requires_grad`` off. Over a mesh each gradient is
    placed as its parameter is (the FSDP reduce-scatter), and the loss is
    the global one, a plain tensor equal on every rank."""
    P = tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in P]
    loss = loss_fn(model, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)

    def place(loss, *grads):
        grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
                 for p, g in zip(P, grads)]
        loss = loss.detach()
        if isinstance(loss, DTensor):     # partial sums over dp: the global loss
            loss = loss.full_tensor()
        return loss, grads

    loss, grads = at_site("grad_placement", place, loss, *grads)
    return loss, tree_unflatten(params, grads)


def _chunks(batch, n):
    """Split every entry of the batch along its leading axis into n equal
    chunks (the reference's reshape to (n, B // n, ...)). Over a mesh a
    chunk holds the same rows as in one process, re-split over dp (the
    slice gathers the batch's rows: ints and a mask, a few bytes a token)."""
    B = batch["tokens"].shape[0]
    mb = B // n
    return [{k: shard_hint(v[i * mb:(i + 1) * mb], "dp", site="microbatch_rows")
             for k, v in batch.items()}
            for i in range(n)]


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, microbatch: int = 0):
    """Returns train_step(state, batch) -> (state, metrics), which updates
    ``state`` in place and returns it.

    microbatch > 0 splits the batch into chunks of that many rows: their
    losses and gradients are summed in fp32 and divided by the chunk count
    before one optimizer update (the reference's ``lax.scan``), so
    activation memory drops by the chunk ratio."""

    def step(state: TrainState, batch):
        B = batch["tokens"].shape[0]
        if microbatch and B > microbatch:
            if B % microbatch:
                raise ValueError(f"batch {B} is not a multiple of microbatch {microbatch}")
            nmb = B // microbatch
            loss, grads = None, None
            for chunk in _chunks(batch, nmb):
                l, g = loss_and_grads(model, state.params, chunk)
                if grads is None:
                    loss, grads = l, g
                else:
                    loss = loss + l
                    torch._foreach_add_(tree_leaves(grads), tree_leaves(g))
                del g
            loss = loss / nmb
            torch._foreach_div_(tree_leaves(grads), float(nmb))
        else:
            loss, grads = loss_and_grads(model, state.params, batch)
        _, _, om = adamw_update(state.params, grads, state.opt, opt_cfg)
        state.step += 1
        return state, {"loss": loss, **om}

    return step


# ---------------------------------------------------------------------------
# int8 compressed gradient all-reduce (distributed-optimization trick)
# ---------------------------------------------------------------------------

def compressed_psum(x, group=None):
    """Quantize to int8 (per-tensor scale), sum over the group, dequantize.

    The scale comes from the group's max |x| (an fp32 all-reduce MAX first),
    so every rank quantizes on the same grid; the int8 codes are summed as
    int32 (the reference's ``psum`` of ``q.astype(int32)``)."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale


def make_dp_train_step(model: Model, opt_cfg: AdamWConfig, *, group=None,
                       compress: bool = True):
    """Pure data-parallel train step over a ``torch.distributed`` group
    whose ranks hold the same parameters: a local backward on this rank's
    batch, then the mean all-reduce of every gradient (int8-compressed
    through ``compressed_psum`` unless ``compress`` is False) and of the
    loss, then the same AdamW update on every rank. The counterpart of the
    reference's ``make_shardmap_dp_train_step``; runs on ``gloo`` (CPU) or
    ``nccl`` (GPU)."""

    def step(state: TrainState, batch):
        loss, grads = loss_and_grads(model, state.params, batch)
        n = dist.get_world_size(group)
        leaves = tree_leaves(grads)
        if compress:
            leaves = [compressed_psum(g, group) / n for g in leaves]
            grads = tree_unflatten(grads, leaves)
        else:
            for g in leaves:
                dist.all_reduce(g, group=group)
            torch._foreach_div_(leaves, float(n))
        dist.all_reduce(loss, group=group)
        loss = loss / n
        _, _, om = adamw_update(state.params, grads, state.opt, opt_cfg)
        state.step += 1
        return state, {"loss": loss, **om}

    return step
