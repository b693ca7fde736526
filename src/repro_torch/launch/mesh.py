"""Mesh construction over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group. ``make_production_mesh`` and ``make_test_mesh`` build a
``DeviceMesh`` over the initialized default group (its world size must be
the mesh's size); ``available_mesh`` takes whatever group exists.

Ranks that share one card run over gloo (nccl refuses two ranks on one
device). DTensor moves data with the functional collectives, and their
``wait_tensor`` crashes on gloo's work over CUDA tensors (torch 2.11: a
segmentation fault in every rank at the first redistribution), where the
c10d collectives on the same tensors run. A process whose ranks share a
card over gloo therefore calls ``sync_collectives("cuda")`` itself before
it builds a cuda mesh (the training launcher does where ``join_ranks``
chose gloo on the card): CUDA kernels of the functional collectives that
call the c10d ones, which return when done. Building a mesh never
installs them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_test_mesh", "available_mesh", "sync_collectives"]


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


_SYNC_LIBS: dict = {}
_REDUCE = {"sum": "SUM", "avg": "SUM", "product": "PRODUCT", "min": "MIN", "max": "MAX"}


def sync_collectives(device_type: str) -> None:
    """Register, for tensors of ``device_type``, kernels of the functional
    collectives that DTensor's redistributions call (``_c10d_functional``:
    all-gather, reduce-scatter, all-reduce, all-to-all, broadcast, their
    coalesced forms, and ``wait_tensor``), each running the c10d collective
    to its end, so ``wait_tensor`` has nothing left to wait for. For the
    rest of the process and every group (the kernels are keyed by device,
    not by group), so only a process whose collectives on ``device_type``
    all run over gloo calls it: a collective on a group of another backend
    raises. Idempotent. Over gloo the data of every collective passes
    through the host, and the step waits for each one."""
    if device_type in _SYNC_LIBS:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def group(name):
        g = _resolve_process_group(name) if isinstance(name, str) else name
        if dist.get_backend(g) != "gloo":
            raise RuntimeError(f"sync_collectives serves gloo groups; this one is "
                               f"{dist.get_backend(g)}")
        return g

    def all_reduce_(x, op, name):
        dist.all_reduce(x, op=getattr(dist.ReduceOp, _REDUCE[op]), group=group(name))
        if op == "avg":
            x.div_(dist.get_world_size(group(name)))
        return x

    def all_gather(x, size, name):
        out = x.new_empty((x.shape[0] * size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group(name))
        return out

    def reduce_scatter(x, op, size, name):
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=getattr(dist.ReduceOp, _REDUCE[op]),
                                   group=group(name))
        if op == "avg":
            out.div_(size)
        return out

    def all_to_all(x, out_splits, in_splits, name):
        rows = sum(out_splits) if out_splits else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_splits) or None,
                               list(in_splits) or None, group=group(name))
        return out

    def broadcast_(x, src, name):
        g = group(name)
        dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
        return x

    lib = torch.library.Library("_c10d_functional", "IMPL")
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    impls = {
        "all_reduce": lambda x, op, name: all_reduce_(x.clone(), op, name),
        "all_reduce_": all_reduce_,
        "all_reduce_coalesced": lambda xs, op, name: [all_reduce_(x.clone(), op, name)
                                                      for x in xs],
        "all_gather_into_tensor": all_gather,
        "all_gather_into_tensor_coalesced": lambda xs, size, name: [all_gather(x, size, name)
                                                                    for x in xs],
        "reduce_scatter_tensor": reduce_scatter,
        "reduce_scatter_tensor_coalesced": lambda xs, op, size, name: [
            reduce_scatter(x, op, size, name) for x in xs],
        "all_to_all_single": all_to_all,
        "broadcast": lambda x, src, name: broadcast_(x.clone(), src, name),
        "broadcast_": broadcast_,
        "wait_tensor": lambda x: x,
    }
    for name, fn in impls.items():
        lib.impl(name, fn, key)
    _SYNC_LIBS[device_type] = lib


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 devices a pod; ``multi_pod`` adds the 2-pod axis."""
    if multi_pod:
        return _device_mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _device_mesh(device_type, (16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 4, *, device_type: str = "cpu"):
    """A small (data, model) mesh for multi-rank tests."""
    return _device_mesh(device_type, (data, model), ("data", "model"))


def available_mesh(device_type: str = "cuda", *, model: int = 0):
    """A (data, model) mesh over the initialized group's ranks, of ``device_type``
    (the one ``launch.serve.join_ranks`` chose: cuda on the card, cpu with
    ``--device cpu``); ``model`` ranks on the model dim, or (0) the first of
    8, 4, 2, 1 that divides the world size. Without a group, the 1 x 1
    ``AbstractMesh`` of one device."""
    if not (dist.is_available() and dist.is_initialized()):
        return AbstractMesh((1, 1), ("data", "model"))
    n = dist.get_world_size()
    model = model or next(m for m in (8, 4, 2, 1) if n % m == 0)
    if n % model:
        raise ValueError(f"a model dim of {model} does not divide {n} ranks")
    return _device_mesh(device_type, (n // model, model), ("data", "model"))
