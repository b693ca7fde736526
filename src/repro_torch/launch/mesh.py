"""Mesh construction over ``torch.distributed`` (the port of
``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group. ``make_production_mesh`` and ``make_test_mesh`` build a
``DeviceMesh`` over the initialized default group (its world size must be
the mesh's size); ``available_mesh`` takes whatever group exists.
"""
from __future__ import annotations

import torch.distributed as dist

from ..models.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_test_mesh", "available_mesh"]


def _device_mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 devices a pod; ``multi_pod`` adds the 2-pod axis."""
    if multi_pod:
        return _device_mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _device_mesh(device_type, (16, 16), ("data", "model"))


def make_test_mesh(data: int = 2, model: int = 4, *, device_type: str = "cpu"):
    """A small (data, model) mesh for multi-rank tests."""
    return _device_mesh(device_type, (data, model), ("data", "model"))


def available_mesh(device_type: str = "cuda"):
    """A (data, model) mesh over the initialized group's ranks, model the
    first of 8, 4, 2, 1 that divides the world size; without a group, the
    1 x 1 ``AbstractMesh`` of one device."""
    if not (dist.is_available() and dist.is_initialized()):
        return AbstractMesh((1, 1), ("data", "model"))
    n = dist.get_world_size()
    model = next(m for m in (8, 4, 2, 1) if n % m == 0)
    return _device_mesh(device_type, (n // model, model), ("data", "model"))
