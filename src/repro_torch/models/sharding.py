"""Logical-axis sharding rules (MaxText-style), resolved per mesh (the port of
``repro.models.sharding`` onto ``torch.distributed``'s ``DeviceMesh``).

Parameters and activations carry *logical* axis names; ``AxisRules`` maps
them to the mesh's named dims. The same model definition then places over
(data, model), (pod, data, model), a small test mesh or a single device
(every rule empty).

Default production rules:
  dp    -> ("pod", "data")  batch (gradients all-reduced across it)
  fsdp  -> ("data",)        parameter/optimizer sharding (ZeRO-3 inside a
                            pod; pods replicate parameters)
  tp    -> ("model",)       tensor parallel: heads / mlp hidden / vocab
  sp    -> ("model",)       sequence dim of long-context KV caches

A mesh is anything with ``mesh_dim_names`` and ``shape``: a ``DeviceMesh``,
or an ``AbstractMesh`` (names and sizes, no devices) where no process group
exists. ``NamedSharding.placements`` turns a per-dim spec into DTensor
placements: a tensor dim over several mesh dims, e.g. ("pod", "data"), is
``Shard(dim)`` on each of them, split in the mesh's dim order (the first
mesh dim outermost), which gives every device the block that the
reference's ``NamedSharding`` gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

__all__ = ["AxisRules", "AbstractMesh", "NamedSharding", "SINGLE_DEVICE_RULES",
           "logical_spec", "named_sharding", "placements_for", "set_active_rules",
           "shard_hint", "divisible", "axis_size"]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's names and sizes without devices or a process group."""

    shape: tuple
    mesh_dim_names: tuple


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: tuple  # ((logical, (physical, ...)), ...)

    @staticmethod
    def make(mesh, *, fsdp_over_pod: bool = False) -> "AxisRules":
        if mesh is None:
            return SINGLE_DEVICE_RULES
        names = tuple(mesh.mesh_dim_names)
        has_pod = "pod" in names
        dp = tuple(a for a in (("pod",) if has_pod else ()) + ("data",) if a in names)
        fsdp = ("pod", "data") if (has_pod and fsdp_over_pod) else ("data",)
        fsdp = tuple(a for a in fsdp if a in names)
        tp = ("model",) if "model" in names else ()
        mapping = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": tp,
                   "shard": names}   # full-mesh index sharding (ANN)
        return AxisRules(tuple(mapping.items()))

    def resolve(self, logical: Optional[str]):
        """The mesh dim (or tuple of dims) a logical axis maps to; None when
        it maps to none."""
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                if not v:
                    return None
                return v if len(v) > 1 else v[0]
        raise KeyError(f"unknown logical axis {logical!r}")

    def mesh_size(self, logical: str, mesh) -> int:
        return axis_size(mesh, self.resolve(logical))


SINGLE_DEVICE_RULES = AxisRules(tuple((k, ()) for k in ("dp", "fsdp", "tp", "sp", "shard")))


def axis_size(mesh, phys) -> int:
    """The number of devices along a mesh dim, a tuple of them, or None (1)."""
    if phys is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    s = 1
    for a in (phys if isinstance(phys, tuple) else (phys,)):
        s *= sizes[a]
    return s


def logical_spec(axes: Sequence[Optional[str]], rules: AxisRules) -> tuple:
    """('fsdp', 'tp', None) -> ('data', 'model', None): the physical axes
    per tensor dim (the reference's ``PartitionSpec`` as a tuple)."""
    return tuple(rules.resolve(a) for a in axes)


def placements_for(mesh, spec: Sequence) -> tuple:
    """DTensor placements, one per mesh dim, of a per-tensor-dim spec."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, phys in enumerate(spec):
        if phys is None:
            continue
        idx = [names.index(a) for a in (phys if isinstance(phys, tuple) else (phys,))]
        if idx != sorted(idx):
            raise ValueError(f"dim {dim} over {phys}: several mesh dims must come in the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh dim {names[i]!r} shards two dims of {tuple(spec)}")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement over a mesh: ``spec`` holds the physical axes per
    tensor dim, as the reference's ``NamedSharding(mesh, P(*spec))``."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


# the rules in-model sharding hints resolve against (set by a launcher
# around a step; None -> hints are no-ops)
_ACTIVE_RULES: list = [None]


def set_active_rules(rules: Optional[AxisRules]) -> None:
    _ACTIVE_RULES[0] = rules


def shard_hint(x, *logical):
    """Redistribute a DTensor to the placements of its logical axes; the
    identity with no rules active, on a plain tensor, or when every axis
    resolves to None."""
    rules = _ACTIVE_RULES[0]
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = logical_spec(logical, rules)
    if all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements_for(x.device_mesh, spec))


def named_sharding(mesh, axes: Sequence[Optional[str]],
                   rules: Optional[AxisRules] = None) -> Optional[NamedSharding]:
    if mesh is None:
        return None
    rules = rules or AxisRules.make(mesh)
    return NamedSharding(mesh, logical_spec(axes, rules))


def divisible(dim: int, logical: str, mesh, rules: Optional[AxisRules]) -> bool:
    """True if ``dim`` can be sharded over the logical axis on this mesh."""
    if mesh is None:
        return True
    rules = rules or AxisRules.make(mesh)
    return dim % rules.mesh_size(logical, mesh) == 0
