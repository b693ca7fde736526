"""Step builders and sharding resolution shared by the LM launchers (the
port of ``repro.launch.steps``).

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

``place_tree`` puts a tree on a mesh as DTensors (``jax.device_put(tree,
shardings)``), ``place_in_turn`` does so one rank at a time (ranks sharing
a card; ``sharded_train_state`` builds a train state that way),
``gather_tree`` takes it back, and ``build_cell`` gives one (arch x shape
x mesh) cell: its step function, its inputs as meta tensors and their
shardings (the reference's ``out_shardings`` waits for a reader). ``run_cell`` executes a cell on real values: it places
them and calls the step with the rules active (``models.sharding.on_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models import encdec as ED
from ..models import hybrid as HY
from ..models import stack as ST
from ..models.config import SHAPES, ArchConfig, ShapeSpec
from ..models.model import Model
from ..models.sharding import AxisRules, NamedSharding, axis_size, on_mesh
from ..training.optimizer import AdamWConfig, OptState, init_opt_state
from ..training.train_step import TrainState, make_train_step

__all__ = ["named_shardings_for", "batch_logical", "abstract_params", "abstract_cache",
           "place_tree", "gather_tree", "place_in_turn", "sharded_train_state", "CellSpec",
           "build_cell", "run_cell", "train_state_logical"]


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


def _walk2(tree, other, fn):
    """``tree``'s structure with fn(leaf, other's leaf at that place) at each
    tensor leaf; other leaves pass through."""
    if torch.is_tensor(tree):
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: _walk2(tree[k], other[k], fn) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk2(a, b, fn) for a, b in zip(tree, other))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _walk2(getattr(tree, f.name), getattr(other, f.name), fn)
            for f in dataclasses.fields(tree)})
    return tree


def place_tree(tree, shardings):
    """Every tensor leaf of ``tree`` as a DTensor placed by the
    ``NamedSharding`` at its place in ``shardings``; other leaves (a cache's
    host-int length) pass through. Each rank must hold the same values:
    every rank builds the whole leaf from the same seed, and keeps its own
    blocks (``distribute_tensor(..., src_data_rank=None)``: no collective),
    so a caller that drops ``tree`` afterwards holds only its shards."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, sh: NamedSharding):
        for dim, phys in zip(t.shape, sh.spec):
            # named_shardings_for demotes every axis that does not divide
            assert phys is None or dim % axis_size(sh.mesh, phys) == 0, (tuple(t.shape), sh.spec)
        return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)

    return _walk2(tree, shardings, one)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its full plain tensor (a collective:
    every rank calls it); other leaves pass through."""
    from torch.distributed.tensor import DTensor

    return _walk2(tree, tree, lambda t, _: t.full_tensor() if isinstance(t, DTensor) else t)


def place_in_turn(make, shardings):
    """``place_tree(make(), shardings)`` with the ranks in turn: each builds
    the whole tree (from a seed: the same values on every rank), keeps its
    blocks and frees the rest before the next rank starts, so at most one
    full copy exists at a time (ranks that share one card). A collective:
    every rank of the default group calls it."""
    import torch.distributed as dist

    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            out = place_tree(make(), shardings)
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def sharded_train_state(model: Model, seed: int, shardings) -> TrainState:
    """The train state of ``seed`` placed by ``shardings`` (a ``TrainState``
    of them): the fp32 parameters built in turn (``place_in_turn``), the
    moments zeros in their parameters' placements, the counters at 0."""
    params = place_in_turn(lambda: model.init(torch.Generator(model.device).manual_seed(seed)),
                           shardings.params)
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return TrainState(params=params,
                      opt=dataclasses.replace(init_opt_state(params),
                                              step=place_tree(step, shardings.opt.step)),
                      step=place_tree(step.clone(), shardings.step))


def train_state_logical(pspec) -> TrainState:
    """The logical axes of a ``TrainState`` whose parameters have ``pspec``:
    the moments as the parameters, the step counters replicated."""
    return TrainState(params=pspec, opt=OptState(mu=pspec, nu=pspec, step=()), step=())


@dataclasses.dataclass
class CellSpec:
    """Everything needed to run one (arch x shape x mesh) cell."""

    fn: Any                 # the step: train step, prefill or decode
    in_sds: tuple           # meta-tensor trees (positional)
    in_shardings: tuple
    donate: tuple = ()      # kept as metadata: the steps update in place
    name: str = ""
    demotions: list = dataclasses.field(default_factory=list)
    rules: Optional[AxisRules] = None


def build_cell(cfg: ArchConfig, shape_name: str, mesh, *, rules: Optional[AxisRules] = None,
               opt_cfg: Optional[AdamWConfig] = None, microbatch: int = 0,
               shape: Optional[ShapeSpec] = None, device=None) -> CellSpec:
    """The step, its inputs as meta tensors and their shardings for one
    cell; nothing is allocated. ``shape`` replaces ``SHAPES[shape_name]``.
    The model runs on ``device`` (None: the mesh's device type)."""
    from ..configs.common import input_specs

    rules = rules or AxisRules.make(mesh)
    spec = shape or SHAPES[shape_name]
    model = Model(cfg, device=device or getattr(mesh, "device_type", "cpu"))
    tp_size = rules.mesh_size("tp", mesh)
    demo: list = []

    batch_sds = input_specs(cfg, shape_name, shape=spec)
    batch_sh = named_shardings_for(batch_sds, batch_logical(batch_sds), mesh, rules, demo)
    pspec = model.param_specs(tp_size)
    params_sds = abstract_params(cfg)

    if spec.kind == "train":
        step0 = torch.empty((), dtype=torch.int32, device="meta")
        state_sds = TrainState(params=params_sds, opt=OptState(
            mu=params_sds, nu=params_sds, step=step0), step=step0)
        state_sh = named_shardings_for(state_sds, train_state_logical(pspec), mesh, rules,
                                       demo)
        step = make_train_step(model, opt_cfg or AdamWConfig(), microbatch=microbatch)
        return CellSpec(fn=step, in_sds=(state_sds, batch_sds),
                        in_shardings=(state_sh, batch_sh), donate=(0,),
                        name=f"{cfg.name}:{shape_name}:train", demotions=demo, rules=rules)

    # serving runs on weights in the activation dtype (fp32 masters are a
    # training artifact); model code casts at use sites either way
    params_sds = _cast_tree(params_sds, cfg.activation_dtype)
    params_sh = named_shardings_for(params_sds, pspec, mesh, rules, demo)
    B, T = spec.global_batch, spec.seq_len
    cache_sds = abstract_cache(cfg, B, T, cfg.activation_dtype)
    cache_sh = named_shardings_for(cache_sds, model.cache_specs(tp_size, T), mesh, rules, demo)

    if spec.kind == "prefill":
        return CellSpec(fn=model.prefill, in_sds=(params_sds, batch_sds, cache_sds),
                        in_shardings=(params_sh, batch_sh, cache_sh), donate=(2,),
                        name=f"{cfg.name}:{shape_name}:prefill", demotions=demo, rules=rules)

    # decode: one token against a seq_len-deep cache
    tok_sds = batch_sds["tokens"]
    tok_sh = named_shardings_for({"t": tok_sds}, {"t": ("dp", None)}, mesh, rules, demo)["t"]
    return CellSpec(fn=model.decode_step, in_sds=(params_sds, tok_sds, cache_sds),
                    in_shardings=(params_sh, tok_sh, cache_sh), donate=(2,),
                    name=f"{cfg.name}:{shape_name}:decode", demotions=demo, rules=rules)


def _cast_tree(tree, dtype):
    """fp32 leaves of a parameter dict cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def run_cell(cell: CellSpec, *values):
    """Execute ``cell`` on real values (trees shaped as ``cell.in_sds``, the
    same on every rank): place each on its shardings, then call the step
    with the cell's rules active. Serving weights are cast to the dtype of
    ``in_sds`` first."""
    placed = []
    for v, sds, sh in zip(values, cell.in_sds, cell.in_shardings):
        v = _walk2(v, sds, lambda t, s: t.to(s.dtype) if t.dtype != s.dtype else t)
        placed.append(place_tree(v, sh))
    with on_mesh(cell.rules):
        return cell.fn(*placed)
