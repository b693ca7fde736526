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

import contextlib
import dataclasses
from typing import Any, Optional, Sequence

import torch

__all__ = ["AxisRules", "AbstractMesh", "NamedSharding", "SINGLE_DEVICE_RULES",
           "logical_spec", "named_sharding", "placements_for", "set_active_rules",
           "active_rules", "on_mesh", "shard_hint", "replicated", "reduced", "local_map",
           "mesh_size_of", "rows_local", "divisible", "axis_size", "SITES", "at_site",
           "current_site", "labelling"]


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


@contextlib.contextmanager
def active_rules(rules: Optional[AxisRules]):
    """Set the rules that shard hints resolve against for the body, and
    restore the previous ones on the way out (a failed step included)."""
    prev = _ACTIVE_RULES[0]
    _ACTIVE_RULES[0] = rules
    try:
        yield rules
    finally:
        _ACTIVE_RULES[0] = prev


@contextlib.contextmanager
def on_mesh(rules: Optional[AxisRules]):
    """The context a step runs in over a mesh: ``rules`` active for the
    shard hints, and DTensor's ``implicit_replication``, so the plain
    tensors a step makes for itself (positions, masks, RoPE tables, the
    MoE aux loss's zero, the flash loop's running max) meet the DTensors as
    replicated values, which is what they are."""
    from torch.distributed.tensor.experimental import implicit_replication

    with active_rules(rules), implicit_replication():
        yield rules


def _even_spec(shape, logical, rules, mesh) -> tuple:
    """The physical axes of ``logical`` over ``shape``, an axis that does not
    divide its dim dropped (``launch.steps.named_shardings_for``'s
    demotion), so no DTensor shard is ever uneven."""
    spec = logical_spec(tuple(logical) + (None,) * (len(shape) - len(logical)), rules)
    return tuple(None if p is None or dim % axis_size(mesh, p) else p
                 for dim, p in zip(shape, spec))


def shard_hint(x, *logical, site: str = "shard_hint"):
    """Redistribute a DTensor to the placements of its logical axes; the
    identity with no rules active, on a plain tensor, or when every axis
    resolves to None. An axis that does not divide its dim is dropped. Its
    collectives count under ``site`` (``at_site``)."""
    rules = _ACTIVE_RULES[0]
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = _even_spec(x.shape, logical, rules, x.device_mesh)
    if all(s is None for s in spec):
        return x
    return at_site(site, lambda t: t.redistribute(t.device_mesh,
                                                  placements_for(t.device_mesh, spec)), x)


def reduced(x, *, site: str = "row_parallel"):
    """A DTensor whose partial sums are summed (each ``Partial`` mesh dim
    made ``Replicate``, its shards kept); a plain tensor, or one with no
    partial sum, as it is. Its collectives count under ``site``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    place = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return at_site(site, lambda t: t.redistribute(t.device_mesh, place), x)


def replicated(x, *, site: str = "shard_hint"):
    """A DTensor redistributed to be whole on every rank (an all-gather of
    its shards); a plain tensor as it is. Its collectives count under
    ``site``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return at_site(site, lambda t: t.redistribute(t.device_mesh,
                                                  [Replicate()] * t.device_mesh.ndim), x)


def mesh_size_of(x, logical: str) -> int:
    """The number of devices the logical axis spans on a DTensor's mesh under
    the active rules; 0 for a plain tensor (the ``tp_size`` of one process)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return 0
    mesh = x.device_mesh
    return (_ACTIVE_RULES[0] or AxisRules.make(mesh)).mesh_size(logical, mesh)


def local_map(fn, args, in_axes, out_axes, *, partial: Optional[str] = None,
              site: Optional[str] = None):
    """``fn`` over each rank's own blocks: torch's
    ``torch.distributed.tensor.experimental.local_map`` with logical axes.
    With DTensor arguments, argument i is redistributed to the placements of
    its logical axes ``in_axes[i]``, ``fn`` runs on the local tensors, and
    each tensor it returns comes back as a DTensor placed by ``out_axes``
    (one tuple for the one output, or a list of them, one an output),
    summed over the mesh dims of ``partial`` (a logical axis) where ``fn``
    leaves partial sums. A logical axis that does not divide an argument's
    dim is dropped there and from the outputs (and from ``partial``). A
    plain tensor argument with axes (a mask the step made, whole on every
    rank) is split as a replicated DTensor would be; an argument replicated
    over a mesh dim that splits the work gets a partial gradient there.
    Other arguments (None, a plain tensor without axes) reach ``fn`` as
    they are. With plain tensors (one process) it is ``fn(*args)``. For
    ops that DTensor cannot shard, or shards in a layout whose view or
    backward fails, or loops of small ops whose dispatch over DTensors
    costs more than their work. Its collectives count under ``site``
    (``at_site``)."""
    if site is not None:
        return at_site(site, lambda *a: local_map(fn, a, in_axes, out_axes, partial=partial),
                       *args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map as torch_local_map

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    rules = _ACTIVE_RULES[0] or AxisRules.make(mesh)
    args, slots, places, dropped = list(args), [], [], set()
    for i, (a, ax) in enumerate(zip(args, in_axes)):
        if torch.is_tensor(a) and not isinstance(a, DTensor) and any(ax):
            a = args[i] = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim)
        if isinstance(a, DTensor):
            ax = tuple(ax) + (None,) * (a.dim() - len(ax))
            spec = _even_spec(a.shape, ax, rules, mesh)
            dropped |= {lg for lg, sp in zip(ax, spec) if lg and sp is None}
            slots.append(i)
            places.append(placements_for(mesh, spec))
    split = {d for pl in places for d, p in enumerate(pl) if isinstance(p, Shard)}
    grads = [tuple(Partial() if d in split and not isinstance(p, Shard) else p
                   for d, p in enumerate(pl)) for pl in places]
    summed = None if partial is None or partial in dropped else rules.resolve(partial)
    summed = {mesh.mesh_dim_names.index(a) for a in
              (summed if isinstance(summed, tuple) else (summed,)) if a is not None}

    def out_place(ax):
        place = placements_for(mesh, logical_spec(
            tuple(None if lg in dropped else lg for lg in ax), rules))
        return [Partial() if d in summed else p for d, p in enumerate(place)]

    one = not isinstance(out_axes, list)
    outs = out_place(out_axes) if one else tuple(out_place(ax) for ax in out_axes)

    def on_blocks(*local):
        full = list(args)
        for i, t in zip(slots, local):
            full[i] = t
        out = fn(*full)
        return out.contiguous() if one else tuple(t.contiguous() for t in out)

    return torch_local_map(on_blocks, outs, tuple(places), tuple(grads), mesh,
                           redistribute_inputs=True)(*(args[i] for i in slots))


def rows_local(fn, *args, site: Optional[str] = None):
    """``fn`` over each rank's own batch rows: ``local_map`` with every
    argument and output split by its leading dim over dp, replicated over
    the other mesh dims. For a scatter or gather by computed indices, which
    DTensor cannot shard, whose indices are row-local."""
    return local_map(fn, args, [("dp",)] * len(args), ("dp",), site=site)


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


# ---------------------------------------------------------------------------
# explicit redistribution sites, labelled for a collective tally
# ---------------------------------------------------------------------------

# The sites where the port redistributes or runs local blocks itself (PERF.md
# lists them), numbered as there; "shard_hint" is the reference's hints and
# every collective outside a site is DTensor's own propagation.
SITES = ("embed_table", "gold_logit", "grad_placement", "microbatch_rows", "attention_core",
         "mamba2_block", "moe_local", "grad_norm", "head_projection", "mlp_block",
         "row_parallel", "shard_hint")
_SITE: list = [None]        # the site collectives are counted under now
_LISTENERS: list = [0]      # tallies listening: without one a site is a plain call


def current_site() -> Optional[str]:
    """The site whose collectives run now (None: DTensor's propagation)."""
    return _SITE[0]


@contextlib.contextmanager
def labelling():
    """Sites label their collectives for the body (a tally's window)."""
    _LISTENERS[0] += 1
    try:
        yield
    finally:
        _LISTENERS[0] -= 1
        if not _LISTENERS[0]:
            _SITE[0] = None


class _Label(torch.autograd.Function):
    """The identity, whose backward sets the current site: marks placed on
    a site's outputs set it as the backward enters the site, and marks on
    its inputs restore the outer one as the backward leaves it (the engine
    runs a site's nodes, recorded between the two marks, between them)."""

    @staticmethod
    def forward(ctx, label, x):
        ctx.label = label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _SITE[0] = ctx.label
        return None, g


def _mark(x, label):
    if torch.is_tensor(x) and x.requires_grad and torch.is_grad_enabled():
        return _Label.apply(label, x)
    return x


def at_site(name: str, fn, *args):
    """``fn(*args)``, its collectives (forward and backward) counted under
    ``name`` while a tally listens (``labelling``); else just the call."""
    if not _LISTENERS[0]:
        return fn(*args)
    outer = _SITE[0]
    args = tuple(_mark(a, outer) for a in args)
    _SITE[0] = name
    try:
        out = fn(*args)
    finally:
        _SITE[0] = outer
    if isinstance(out, (tuple, list)):
        return type(out)(_mark(o, name) for o in out)
    return _mark(out, name)
