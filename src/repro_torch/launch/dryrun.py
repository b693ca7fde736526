"""The dry run: every (architecture x input shape x mesh) cell's step run
on the production mesh without its data (the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --out build/dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
        --shape train_4k --mesh single --extrapolate
    PYTHONPATH=src python -m repro_torch.launch.dryrun --queue --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --external --store mmap --device cpu

The reference lowers and compiles each cell against 512 placeholder host
devices and reads XLA's analyses. The port has no compiler: it runs the
step itself, in one process that is rank 0 of a ``"fake"`` process group
of 256 (16 x 16) or 512 (2 x 16 x 16) ranks (``fake_world``; its
collectives return at once and move nothing), on CPU ``FakeTensor``s
(shapes and dtypes, no storage) placed as DTensors by the cell's
shardings. That is the design for the LM cells, not a fallback: a fake
world is the placeholder devices' counterpart, and nothing of a cell runs
on a card. Per cell it records what rank 0 does:

* ``memory.argument_bytes``: the inputs' local shard bytes, from
  ``compute_local_shape_and_global_offset`` over ``build_cell``'s inputs
  at the full config (no step run). Shards are even (``named_shardings_for``
  demotes every axis that does not divide), so rank 0 is the fullest rank.
  A decode cache's lengths are host ints and count no bytes.
* ``memory.output_bytes``: the same over the step's outputs.
* ``memory.temp_bytes``: None, with ``memory.note`` saying why:
  ``torch.distributed._tools.MemTracker`` runs under ``FakeTensorMode`` but
  counts DTensors at their wrapper (global) size, not their local shards,
  and a count of the live local fake storages op by op does not see the
  backward free them (it read 153 GB for one layer of h2o-danube-1.8b's
  train_4k). ``memory.generated_code_bytes`` is None: there is no
  compiled program.
* ``cost.flops``: per device. ``FlopCounterMode`` counts a DTensor op at its
  GLOBAL shapes (torch 2.13: a [64, 32] x [32, 16] product over a 2 x 2
  mesh counts 65,536, the whole product), so the dry run counts the local
  ops instead, with ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``): the products each rank
  runs on its shards, a product every tp rank repeats counted on each.
* ``cost["bytes accessed"]``: XLA's convention, the sum over the step's
  local aten ops of their input and output bytes (each operand of each op,
  views and collectives excluded). Eager torch fuses nothing, so this is
  the unfused count: XLA's is taken after fusion.
* ``collectives``: ``CollectiveTally``'s dict, the reference's five kinds
  by operand bytes on this rank, plus ``by_site``: each explicit
  redistribution site of the port (``models.sharding.SITES``) and
  ``propagation``, DTensor's own redistributions.

``run_cell_extrapolated`` runs the k = 1 and k = 2 depth variants
(``_depth_variant``) and fits cost and collectives linearly in depth, as
the reference does (the port has no ``scan_layers``: only the depth
changes). ``run_ann_cell``'s formula fields are the reference's; its memory
comes from a real shard at a reduced size. ``run_queue_cell`` times
``BatchQueue.warmup`` per rung: the kernels' load (a build on a cold
cache) and the allocator's first use, the port's counterpart of XLA's
compile bill. ``run_external_store_cell`` spills a small index and serves
``plan="external"`` from it. These three touch a device (``--device``,
cuda by default; without a card they raise, as every entry point of the
port does). The reference's ``--hlo-dir`` has no counterpart: there is no
HLO. The module sets no environment variable.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCH_IDS, get_config
from ..models import sharding
from ..models.config import SHAPES
from .mesh import make_production_mesh
from .steps import build_cell

__all__ = ["CollectiveTally", "KINDS", "fake_world", "cell_argument_bytes", "lower_cell",
           "ann_formulas", "run_cell", "run_cell_extrapolated", "run_ann_cell",
           "run_queue_cell", "run_external_store_cell", "main"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# the functional collectives (and DTensor's all-to-all) by the reference's
# kinds; a broadcast sends one rank's block to the others, counted as XLA's
# point-to-point kind
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _collective_kind(func) -> Optional[str]:
    ns = getattr(func, "namespace", "")
    name = getattr(func, "__name__", "").split(".")[0]
    if ns in ("_c10d_functional", "c10d_functional") or (
            ns == "_dtensor" and name == "shard_dim_alltoall"):
        return _KIND.get(name)
    return None


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, type) and issubclass(t, DTensor) for t in types)


class CollectiveTally(TorchDispatchMode):
    """The collectives of a window on this rank, by the reference's kinds
    (``parse_collectives``): every ``_c10d_functional`` /
    ``c10d_functional`` collective and DTensor's ``shard_dim_alltoall``,
    each counted once with its OPERAND bytes (the input on this rank, as
    the reference sums operands, not results). ``result()`` gives the
    reference's dict (the five byte sums, ``total``, ``n_<kind>``) and
    ``by_site``: {site: {"calls", "bytes"}} over the port's explicit
    redistribution sites (``models.sharding.SITES``, labelled while a tally
    is open) and ``propagation`` (DTensor's own).

    The mode lets DTensor run first (it returns NotImplemented for DTensor
    ops, as ``CommDebugMode`` does), so it sees the collectives each rank
    issues. ``launch.mesh.sync_collectives`` replaces the functional ops'
    kernels, not the ops, so its c10d calls count as the ops they stand
    for. On a CPU mesh DTensor gathers and chunks where a card runs
    ``shard_dim_alltoall`` (gloo has no all-to-all); the tally counts that
    gather as the all-to-all it stands for (the same operand bytes), so a
    fake CPU world counts what the card's mesh runs."""

    def __init__(self):
        super().__init__()
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}
        self.by_site: dict = {}
        self._alltoall = 0
        self._stack = None

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(sharding.labelling())
        self._stack.enter_context(self._cpu_alltoall())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    @contextlib.contextmanager
    def _cpu_alltoall(self):
        from torch.distributed.tensor import placement_types as pt

        orig = getattr(pt, "shard_dim_alltoall", None)
        if orig is None:
            yield
            return

        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            cpu = mesh.device_type == "cpu"
            self._alltoall += cpu
            try:
                return orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._alltoall -= cpu

        pt.shard_dim_alltoall = shard_dim_alltoall
        try:
            yield
        finally:
            pt.shard_dim_alltoall = orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if _has_dtensor(types):
            return NotImplemented
        kind = _collective_kind(func)
        if kind is not None:
            if kind == "all-gather" and self._alltoall:
                kind = "all-to-all"
            xs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            self.add(kind, 1, sum(x.numel() * x.element_size() for x in xs),
                     sharding.current_site() or "propagation")
        return func(*args, **kwargs)

    def add(self, kind: str, calls: int, nbytes: int, site: str = "propagation") -> None:
        self.calls[kind] += calls
        self.bytes[kind] += nbytes
        s = self.by_site.setdefault(site, {"calls": 0, "bytes": 0})
        s["calls"] += calls
        s["bytes"] += nbytes

    def result(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out.update({f"n_{k}": v for k, v in self.calls.items()})
        out["by_site"] = {k: dict(v) for k, v in sorted(self.by_site.items())}
        return out


# ops that move no bytes: views and metadata
_NO_BYTES = {"detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias"}


class _StepCost(TorchDispatchMode):
    """Per-device cost of a window: FLOPs (``FlopCounterMode``'s formulas on
    the local ops) and bytes accessed (inputs and outputs of every local op
    but views and collectives). DTensor's sharding propagation runs some
    ops at global shapes on fake tensors to learn their outputs' shapes;
    those run no compute on any rank and are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self._meta = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, op_schema):
            self._meta += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._meta -= 1

        self._unpatch = lambda: setattr(ShardingPropagator,
                                        "_propagate_tensor_meta_non_cached", orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if _has_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._meta:
            return out
        outs = [t for t in tree_leaves(out) if torch.is_tensor(t)]
        name = getattr(func, "__name__", "").split(".")[0]
        if _collective_kind(func) is None and not getattr(func, "is_view", False) \
                and name not in _NO_BYTES:
            fl = flop_registry.get(getattr(func, "_overloadpacket", None))
            if fl is not None:
                self.flops += int(fl(*args, **kwargs, out_val=out))
            ins = [t for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a ``"fake"`` process group of
    ``world_size`` ranks (``torch.testing``'s ``FakeStore``): meshes build,
    collectives return at once and move nothing. Destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _tensor_leaves(tree, shardings):
    """[(tensor, NamedSharding)] of a tree and its shardings, in order."""
    out = []

    def walk(t, sh):
        if torch.is_tensor(t):
            out.append((t, sh))
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], sh[k])
        elif isinstance(t, (list, tuple)):
            for a, b in zip(t, sh):
                walk(a, b)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name), getattr(sh, f.name))

    walk(tree, shardings)
    return out


def cell_argument_bytes(cell) -> int:
    """The cell's inputs' bytes on this rank: each leaf's local shard shape
    from its placements (``compute_local_shape_and_global_offset``); no
    tensor is made."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    total = 0
    for sds, sh in zip(cell.in_sds, cell.in_shardings):
        for t, s in _tensor_leaves(sds, sh):
            shape, _ = compute_local_shape_and_global_offset(tuple(t.shape), s.mesh,
                                                             s.placements)
            total += math.prod(shape) * t.element_size()
    return total


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t, _ in _tensor_leaves(tree, tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def lower_cell(cell) -> dict:
    """Run ``cell``'s step once on fake tensors placed by its shardings, on
    the current process group, and measure it on this rank: {"flops",
    "bytes", "output_bytes", "collectives"}. The fake tensors take the
    mesh's device type: DTensor picks some redistributions by it (on a CPU
    mesh it gathers where a CUDA mesh runs an all-to-all), so a cell meant
    for the card is lowered on a fake CUDA mesh (fake tensors allocate no
    device memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor

    from .steps import _walk2, place_tree

    dev = _tensor_leaves(cell.in_sds[0], cell.in_shardings[0])[0][1].mesh.device_type
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        values = [_walk2(sds, sds, lambda t, _: torch.empty(t.shape, dtype=t.dtype, device=dev))
                  for sds in cell.in_sds]
        placed = [place_tree(v, sh) for v, sh in zip(values, cell.in_shardings)]
        del values
        tally, cost = CollectiveTally(), _StepCost()
        with tally, cost, sharding.on_mesh(cell.rules):
            out = cell.fn(*placed)
        out_bytes = _local_bytes(out)
    return dict(flops=cost.flops, bytes=cost.bytes, output_bytes=out_bytes,
                collectives=tally.result())


_TEMP_NOTE = ("temp_bytes not measured: MemTracker counts DTensors at their global wrapper, "
              "not their local shards, and no live-bytes count of the local fake storages "
              "sees the backward free them")


def _cell_record(arch, shape_name, multi_pod, cfg, tag, overrides) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    if tag:
        rec["tag"] = tag
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    return rec


def _failed(rec, e) -> None:
    rec["status"] = "FAIL"
    rec["error"] = f"{type(e).__name__}: {str(e)[:500]}"
    rec["traceback"] = traceback.format_exc()[-2000:]


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, depth: Optional[int] = None,
             cfg_overrides: Optional[dict] = None, tag: Optional[str] = None) -> dict:
    """One cell's record: its argument bytes at the full config, then one
    step on the fake world (at ``depth`` stack units, ``_depth_variant``,
    when given: recorded as ``depth``, and then ``cost`` and
    ``collectives`` are that depth's)."""
    t0 = time.time()
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    rec = _cell_record(arch, shape_name, multi_pod, cfg, tag, cfg_overrides)
    ok, reason = cfg.supports_shape(shape_name)
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            full = build_cell(cfg, shape_name, mesh)
            arg_bytes = cell_argument_bytes(full)
            cell = full
            if depth is not None:
                rec["depth"] = depth
                cell = build_cell(_depth_variant(cfg, depth)[0], shape_name, mesh)
            got = lower_cell(cell)
        rec["memory"] = {
            "argument_bytes": arg_bytes, "output_bytes": got["output_bytes"],
            "temp_bytes": None, "generated_code_bytes": None, "note": _TEMP_NOTE}
        if depth is not None:
            rec["memory"]["note"] += f"; output bytes at depth {depth}"
        rec["cost"] = {"flops": float(got["flops"]), "bytes accessed": float(got["bytes"])}
        rec["collectives"] = got["collectives"]
        rec["status"] = "OK"
    except Exception as e:
        _failed(rec, e)
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def _depth_variant(cfg, k: int):
    """(config with k stack units, units in the full model). A unit is one
    layer (dense, moe, ssm), one mamba group plus its shared block (hybrid)
    or one encoder + decoder layer pair (encdec), as in the reference; the
    port has no ``scan_layers``, so only the depth changes."""
    if cfg.family == "hybrid":
        gs = cfg.shared_attn_every
        return dataclasses.replace(cfg, n_layers=k * gs), cfg.n_layers // gs
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=k, enc_layers=k), cfg.n_layers
    return dataclasses.replace(cfg, n_layers=k), cfg.n_layers


def run_cell_extrapolated(arch: str, shape_name: str, multi_pod: bool, *,
                          cfg_overrides: Optional[dict] = None,
                          tag: Optional[str] = None) -> dict:
    """Depth-extrapolated cost: run the k = 1 and k = 2 variants, fit flops,
    bytes and collectives (their total and each site's bytes) = const +
    units * slope, evaluate at full depth (exact for the homogeneous
    stacks of every arch)."""
    t0 = time.time()
    cfg_full = get_config(arch)
    if cfg_overrides:
        cfg_full = dataclasses.replace(cfg_full, **cfg_overrides)
    rec = _cell_record(arch, shape_name, multi_pod, cfg_full, tag, cfg_overrides)
    rec["extrapolated"] = True
    ok, reason = cfg_full.supports_shape(shape_name)
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec
    try:
        points, sites = {}, {}
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            for k in (1, 2):
                cfg_k, units = _depth_variant(cfg_full, k)
                got = lower_cell(build_cell(cfg_k, shape_name, mesh))
                points[k] = dict(flops=float(got["flops"]), bytes=float(got["bytes"]),
                                 coll=float(got["collectives"]["total"]))
                sites[k] = got["collectives"]["by_site"]

        def extrap(f1, f2):
            return f1 + (units - 1) * (f2 - f1)

        rec["cost"] = {"flops": extrap(points[1]["flops"], points[2]["flops"]),
                       "bytes accessed": extrap(points[1]["bytes"], points[2]["bytes"])}
        c1, c2 = points[1]["coll"], points[2]["coll"]
        zero = {"calls": 0, "bytes": 0}
        rec["collectives"] = {
            "total": extrap(c1, c2), "per_unit": c2 - c1, "const": 2 * c1 - c2,
            "by_site": {s: {f: extrap(sites[1].get(s, zero)[f], sites[2].get(s, zero)[f])
                            for f in ("calls", "bytes")}
                        for s in sorted(set(sites[1]) | set(sites[2]))}}
        rec["depth_points"] = points
        rec["units"] = units
        rec["status"] = "OK"
    except Exception as e:
        _failed(rec, e)
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


# --------------------------------------------------------------------------
# the ANN, queue and external-store cells
# --------------------------------------------------------------------------

_ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "uint8": 1, "uint16": 2, "int32": 4,
             "uint32": 4}


def ann_formulas(n: int, d: int, devs: int, *, n_queries: int, k: int, db_dtype: str,
                 s_cap_per_shard: Optional[int], fp_dtype: str) -> dict:
    """The reference's ANN cell formulas (``repro.launch.dryrun.run_ann_cell``):
    BIGANN's index parameters over ``devs`` shards, the per-device index
    bytes and the analytic per-chip traffic of the sharded oracle plan."""
    from ..core.probabilities import solve_params

    n_shard = -(-n // devs)
    u_bits = max(8, int(np.floor(np.log2(n_shard))) - 1)
    fp_store_bits = 8 * _ITEMSIZE[fp_dtype]
    params = solve_params(n, d, c=2.0, w=4.0, gamma=1.0, x_max=1.0, max_L=48, max_m=24,
                          u_bits=u_bits, v_bits=min(32, u_bits + min(fp_store_bits, 16)))
    r, L, u = params.r, params.L, params.u
    E_shard = n_shard * L * r
    db_itemsize = _ITEMSIZE[db_dtype]
    s_cap = s_cap_per_shard or 4 * k
    sbuf = max(128, -(-s_cap // 128) * 128)
    blk = params.block_objs
    entry_bytes = 4 + _ITEMSIZE[fp_dtype]
    per_query = (r * L * (4 + 4 + 4)
                 + r * L * 2 * blk * entry_bytes
                 + r * sbuf * (d * db_itemsize + 4))
    return dict(n_shard=n_shard,
                index_params=dict(m=params.m, L=L, r=r, u=u, entries_per_device=E_shard,
                                  index_bytes_per_device=int(E_shard * 6 + r * L * (1 << u) * 8
                                                             + n_shard * d * db_itemsize)),
                s_cap_per_shard=s_cap, analytic_bytes_per_chip=int(n_queries * per_query))


def _device(device):
    from ..kernels.dispatch import resolve_device

    return resolve_device(device)


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)
    return None


def _peak_read(dev, base):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        return torch.cuda.max_memory_allocated(dev) - base
    return None


# the leaves the oracle plan reads (the CSR view; the block store is the
# fused plan's, and the reference's cell gives it placeholder shapes only)
_ORACLE_LEAVES = ("a", "b", "rm", "table_off", "table_cnt", "entries_id", "entries_fp", "db",
                  "db_norm2")


def run_ann_cell(multi_pod: bool, *, n: int = 1_000_000_000, d: int = 128,
                 n_queries: int = 1024, k: int = 10, db_dtype: str = "float32",
                 s_cap_per_shard: Optional[int] = None, fp_dtype: str = "uint16",
                 tag: Optional[str] = None, shard_n: int = 20_000, device=None) -> dict:
    """The paper's workload at production scale: a BIGANN-1B E2LSHoS index
    sharded over every device of the mesh, queried by the sharded oracle
    plan. ``index_params``, ``s_cap_per_shard`` and
    ``analytic_bytes_per_chip`` are the reference's formulas. The port's
    plans read data on the host (an early exit a radius), so no fake tensor
    can stand in for the index: ``memory`` is measured on one real shard of
    ``shard_n`` BIGANN-like byte rows (integers 0-255, as ``db_dtype``)
    built on ``device`` and queried through ``sharded_query_result(...,
    local_plan="oracle")`` (listed in ``reduced``): the bytes of the leaves
    the oracle plan reads and the queries, and the query's peak above them
    on a card (the block store, which only the fused plan reads, is left
    out, as the reference's cell does); ``collectives`` is the
    merge's one all-gather of each shard's packed result (the byte formula
    of ``core.distributed._all_gather``: the merge gathers with c10d,
    which no tally of functional collectives sees)."""
    from ..core.distributed import build_sharded_index, sharded_query_result

    t0 = time.time()
    dev = _device(device)      # no card and no device="cpu": raise, never fall back
    rec = {"arch": "e2lshos-bigann1b", "shape": f"ann_q{n_queries}_k{k}",
           "mesh": _mesh_name(multi_pod), "params": 0, "db_dtype": db_dtype}
    if tag:
        rec["tag"] = tag
    try:
        devs = 512 if multi_pod else 256
        f = ann_formulas(n, d, devs, n_queries=n_queries, k=k, db_dtype=db_dtype,
                         s_cap_per_shard=s_cap_per_shard, fp_dtype=fp_dtype)
        rec["index_params"] = f["index_params"]
        rec["s_cap_per_shard"] = f["s_cap_per_shard"]
        rec["analytic_bytes_per_chip"] = f["analytic_bytes_per_chip"]
        rng = np.random.default_rng(0)
        db = rng.integers(0, 256, size=(shard_n, d)).astype(np.float32)
        qs = (db[rng.choice(shard_n, n_queries)] + rng.normal(size=(n_queries, d))).astype(
            np.float32)
        idx = build_sharded_index(db, 1, seed=0, max_L=48, device=dev)
        if db_dtype != "float32":     # byte data: the cast is lossless
            idx = dataclasses.replace(idx, arrays=tuple(
                dataclasses.replace(ix, db=ix.db.to(getattr(torch, db_dtype)))
                for ix in idx.arrays))
        queries = torch.from_numpy(qs).to(dev)
        base = _peak_reset(dev)
        res = sharded_query_result(idx, queries, k=k, s_cap_per_shard=f["s_cap_per_shard"],
                                   local_plan="oracle")
        temp = _peak_read(dev, base)
        ix = idx.arrays[0]
        rec["memory"] = {"argument_bytes": sum(getattr(ix, f).nbytes for f in _ORACLE_LEAVES)
                         + queries.numel() * 4, "temp_bytes": temp}
        if temp is None:
            rec["memory"]["note"] = "temp_bytes needs a CUDA device's allocator"
        rec["reduced"] = {"shard_n": shard_n, "of": f["n_shard"],
                          "why": "memory from one real shard at this n; the formulas are "
                                 "at full n"}
        packed = (2 * k + 5) * 4          # ids, dists, found, radii, 3 counters: int32
        rec["collectives"] = {kind: 0 for kind in KINDS}
        rec["collectives"]["all-gather"] = n_queries * packed
        rec["collectives"]["total"] = n_queries * packed
        rec["collectives"].update({f"n_{kind}": int(kind == "all-gather") for kind in KINDS})
        rec["collectives_source"] = "formula: core.distributed._all_gather of the packed result"
        rec["result"] = {"rows": int(res.ids.shape[0]),
                         "found": float(res.found.float().mean()),
                         "db_dtype_served": str(idx.arrays[0].db.dtype).split(".")[-1]}
        rec["status"] = "OK"
    except Exception as e:
        _failed(rec, e)
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def run_queue_cell(*, ladder=(8, 32, 128), tick_us: float = 200.0,
                   max_batch: Optional[int] = None, n: int = 100_000, d: int = 128,
                   k: int = 10, device=None) -> dict:
    """The serving queue's warm-up bill: an E2LSHoS index over ``n``
    clustered rows on ``device``, a ``BatchQueue`` over it, and
    ``BatchQueue.warmup`` timed rung by rung (``ladder.<rung>
    .compile_seconds``, the reference's key): each rung runs the masked
    fused plan once over its whole radius schedule, so the first rung pays
    the kernels' load (their build, on a cold cache), the index's hash pack
    and the allocator's first buffers; later rungs pay their own shapes.
    ``memory`` is the largest rung's peak above the index (on a card)."""
    from ..core import E2LSHoS, SearchEngine
    from ..serving import BatchQueue

    t0 = time.time()
    dev = _device(device)
    ladder = BatchQueue.resolve_ladder(ladder, max_batch)
    rec = {"arch": "e2lshos-serving-queue", "shape": f"ladder_{list(ladder)}",
           "mesh": "single-device", "params": 0, "tick_us": tick_us, "max_batch": ladder[-1]}
    try:
        rng = np.random.default_rng(0)
        centers = rng.normal(size=(64, d)).astype(np.float32)
        db = (centers[rng.integers(0, 64, n)] + 0.2 * rng.normal(size=(n, d))).astype(
            np.float32)
        idx = E2LSHoS.build(db, gamma=0.8, max_L=32, seed=0, device=dev)
        p = idx.params
        queue = BatchQueue(SearchEngine(idx, device=dev), k=k, ladder=ladder, tick_us=tick_us,
                           warmup=False)
        rec["index_params"] = dict(m=p.m, L=p.L, r=p.r, u=p.u, S=p.S, block_objs=p.block_objs)
        rungs = {}
        for shape in ladder:
            base = _peak_reset(dev)
            ts = time.time()
            queue.warmup(rungs=(shape,))
            rungs[str(shape)] = {"compile_seconds": round(time.time() - ts, 4)}
            if shape == ladder[-1]:
                rec["memory"] = {"argument_bytes": idx.index.arrays.nbytes(),
                                 "temp_bytes": _peak_read(dev, base)}
        rec["ladder"] = rungs
        rec["warmup_seconds_total"] = round(sum(v["compile_seconds"] for v in rungs.values()), 4)
        rec["status"] = "OK"
    except Exception as e:
        _failed(rec, e)
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def _external_data(n: int, d: int, n_queries: int):
    """The external cell's clustered data and queries (the reference's), and
    the scale both are divided by."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, d)).astype(np.float32)
    db = (centers[rng.integers(0, 16, n)] + 0.15 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (db[rng.choice(n, n_queries, replace=False)]
          + 0.05 * rng.normal(size=(n_queries, d))).astype(np.float32)
    return db, qs, float(np.median(np.linalg.norm(db - db.mean(0), axis=1))) / 3


def run_external_store_cell(*, store: str = "aio", qd: int = 16, n: int = 6000, d: int = 16,
                            n_queries: int = 48, k: int = 4, device=None,
                            spilled: Optional[str] = None) -> dict:
    """External-storage serving cell: build a small index, SPILL it, and
    drive plan="external" through the ``store`` backend, recording the
    first pass's seconds (``compile_seconds``: the kernels' load and the
    store's first reads), the warm pass, the measured N_io against the
    runtime counters, the cache hit rate and each rung's fetch/compute
    overlap. The data, index settings and fields are the reference's.
    ``spilled`` serves that spill file (the reference's format) instead of
    building one: the port and the reference draw their hash families from
    different generators, so only a shared file makes their counts
    comparable."""
    import pathlib
    import tempfile

    from ..core import E2LSHoS, SearchEngine
    from ..storage import load_external

    t0 = time.time()
    dev = _device(device)
    rec = {"arch": "e2lshos-external-store", "shape": f"ann_q{n_queries}_k{k}",
           "mesh": "single-device", "params": 0, "store": store, "qd": qd}
    try:
        db, qs, s = _external_data(n, d, n_queries)
        with tempfile.TemporaryDirectory(prefix="dryrun_spill_") as tmp:
            spill = pathlib.Path(tmp) / "i.e2l"
            ts = time.time()
            if spilled is None:
                E2LSHoS.build(db / s, gamma=0.7, s_scale=2.0, max_L=16, seed=0,
                              device=dev).index.spill(spill)
            else:
                spill = pathlib.Path(spilled)
                rec["spilled"] = str(spill)
            rec["spill"] = dict(bytes=spill.stat().st_size, seconds=round(time.time() - ts, 2))
            with load_external(spill, backend=store, qd=qd, device=dev) as ext:
                engine = SearchEngine(ext)
                rec["backend_resolved"] = ext.store.name
                if ext.store.name == "uring":
                    rec["o_direct"] = bool(ext.store.o_direct)
                fb = getattr(ext.store, "fallback_reason", None)
                if fb:
                    rec["fallback_reason"] = fb
                ts = time.time()
                res = engine.query(qs / s, k=k)
                rec["compile_seconds"] = round(time.time() - ts, 2)
                ts = time.time()
                res = engine.query(qs / s, k=k)
                rec["warm_seconds"] = round(time.time() - ts, 3)
                ps = engine.external.last_plan_stats
                rec["io"] = dict(
                    measured_nio_blocks=ps.measured_nio_blocks,
                    counters_agree=bool(ps.measured_nio_blocks == ps.nio_blocks_counted),
                    cache_hit_rate=round(ps.cache_hit_rate, 4),
                    device_reads=ps.io.device_reads,
                    prefetch_reads=ps.io.prefetch_reads,
                    nio_mean=float(np.mean(res.nio.cpu().numpy())),
                )
                rec["rungs"] = [dict(t=r.t, active=r.active_queries, blocks=r.blocks_fetched,
                                     fetch_ms=round(r.fetch_ms, 2),
                                     prefetch_rows=r.prefetch_rows,
                                     compute_wait_ms=round(r.compute_wait_ms, 2))
                                for r in ps.rungs]
        rec["status"] = "OK"
    except Exception as e:
        _failed(rec, e)
    rec["seconds"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--ann", action="store_true", help="run the BIGANN(1B) ANN cell")
    ap.add_argument("--queue", action="store_true",
                    help="run the serving-queue warm-up cell (BatchQueue.warmup per rung)")
    ap.add_argument("--external", action="store_true",
                    help="run the external-storage cell: spill a small index and drive "
                         "plan=\"external\" through --store")
    ap.add_argument("--store", choices=("mem", "mmap", "aio", "uring"), default="aio",
                    help="BlockStore backend for --external (uring falls back to aio "
                         "where io_uring is unavailable)")
    ap.add_argument("--qd", type=int, default=16, help="async queue depth for --external")
    ap.add_argument("--ladder", default="8,32,128",
                    help="batch-shape ladder for --queue, comma-separated")
    ap.add_argument("--tick-us", dest="tick_us", type=float, default=200.0,
                    help="tick interval recorded in the --queue cell")
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=None,
                    help="cap the --queue ladder at this rung")
    ap.add_argument("--n", type=int, default=100_000, help="the --queue cell's database rows")
    ap.add_argument("--extrapolate", action="store_true",
                    help="depth-extrapolated cost records (roofline input)")
    ap.add_argument("--depth", type=int, default=None,
                    help="run each LM cell's step at this many stack units")
    ap.add_argument("--device", default=None,
                    help="device of the --ann shard, --queue and --external cells "
                         "(default cuda; the LM cells run on a fake CPU world)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)

    def emit(rec):
        line = json.dumps(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        brief = {k: rec.get(k) for k in
                 ("arch", "shape", "mesh", "status", "seconds", "reason", "error")}
        print(json.dumps(brief), flush=True)
        if rec.get("memory"):
            print(f"  memory_analysis: {rec['memory']}", flush=True)
        if rec.get("cost"):
            cost_brief = {k: v for k, v in rec["cost"].items()
                          if k in ("flops", "bytes accessed")}
            print(f"  cost_analysis: {cost_brief}", flush=True)

    if args.queue:
        emit(run_queue_cell(ladder=tuple(int(s) for s in args.ladder.split(",")),
                            tick_us=args.tick_us, max_batch=args.max_batch, n=args.n,
                            device=args.device))
        return

    if args.external:
        emit(run_external_store_cell(store=args.store, qd=args.qd, device=args.device))
        return

    if args.ann:
        for mp in meshes:
            emit(run_ann_cell(mp, device=args.device))
        return

    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                if args.extrapolate:
                    emit(run_cell_extrapolated(arch, shape, mp))
                else:
                    emit(run_cell(arch, shape, mp, depth=args.depth))


if __name__ == "__main__":
    main()
