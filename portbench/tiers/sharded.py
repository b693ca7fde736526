"""Range shards, one rank a shard: every rank holds the database on the host,
builds only its own shard on its card (``build_local_shard``, the parameters
solved for the whole n; the data set the harness made on the card moves to
the host first) and serves it behind ``SearchEngine(local,
group=layout)`` with ``plan="sharded"``, so that each call answers the whole
batch on every shard and merges the shards' top-k parts, all-gathered over
the cell's process group (NCCL on the cards).

``reference`` is the plain reference of such a deployment: each shard's rows
answered in turn by ``reference.py``'s ``Reference`` under the one family
and the per-shard budget, then merged as the sharded plan merges. It imports
nothing of the program.
"""
import dataclasses

import numpy as np
import torch

from portbench.program import Served, sync
from portbench.reference import INVALID, RefParams, RefResult, Reference, family_from_seed


def build(cfg, data, family_seed, device, work_dir, layout):
    from repro_torch.core import SearchEngine
    from repro_torch.core.distributed import build_local_shard
    from repro_torch.core.query import QueryConfig
    shards = int(cfg["shards"])
    if layout is None or layout.shards != shards or layout.query_groups != 1:
        got = None if layout is None else (layout.shards, layout.query_groups)
        raise ValueError(f"tier sharded serves {cfg['name']} on {shards} ranks, one a "
                         f"shard; the cell's ranks form (shards, query groups) {got}")
    # each rank holds the database on the host and only its shard on the card
    data.db = data.db.cpu()
    if torch.device(device).type == "cuda":
        # a shard's two block tables take ~25 GiB each: the allocator grows
        # a segment for each rather than look for a free one among the data
        # set's freed ones
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    b = cfg["build"]
    local = build_local_shard(data.db, shards, layout.shard, c=float(b["c"]),
                              w=float(b["w"]), gamma=float(b["gamma"]),
                              max_L=int(b["max_L"]), seed=family_seed, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()       # the build's transient is freed for NCCL and the window
    p = local.params
    got = dict(m=p.m, L=p.L, r=p.r, S=p.S, u=p.u, fp_bits=p.fp_bits, w=p.w, c=p.c,
               block_objs=p.block_objs,
               max_chain=QueryConfig.from_params(p, k=int(cfg["k"])).max_chain)
    off = sum(1 for key, v in got.items() if float(v) != float(cfg["index"][key]))
    return _RankServed(SearchEngine(local, device=device, group=layout), cfg, got, off,
                       device=device, world=shards, leader=layout.shard == 0)


class _RankServed(Served):
    """``Served`` for one rank of the cell. Its batches are uploaded from
    page-locked host memory (``_lock_pages``), as an offline batch job stages
    them, rather than through CUDA's staged copy of pageable memory, whose
    speed follows the host's. And two guards around the harness's window
    protocol (``portbench/ranks.py``): its barrier before the window sets the
    keys ``window/0`` .. ``window/<ranks - 1>`` to the value that
    ``Ranks.agree`` reads as "stop" after window calls 1 .. ranks - 1. So
    rank 0 deletes those keys at the start of its first window call (once
    every rank's barrier key is there), and every call returns only when its
    answers, and so the all-gather that needs every rank's call, are
    complete: no rank reads a stop decision before rank 0 has deleted the
    stale one, and a read then waits for rank 0's own."""

    def __init__(self, engine, cfg, params, params_off, *, device, world, leader):
        super().__init__(engine, cfg, params, params_off)
        self.device, self.world = device, world
        self.stale = leader
        self.locked = {}

    def close(self) -> None:
        _unlock_pages(self.locked)
        super().close()

    def query(self, rows):
        if torch.device(self.device).type == "cuda":
            _lock_pages(rows, self.locked)
        if self.stale:
            import torch.distributed as dist
            store = dist.distributed_c10d._get_default_store()
            while isinstance(store, dist.PrefixStore):    # the harness's own store
                store = store.underlying_store
            keys = [f"window/{r}" for r in range(self.world)]
            if store.check(keys):
                for key in keys[1:]:
                    store.delete_key(key)
                self.stale = False
        res = super().query(rows)
        sync(self.device)
        return res


def _lock_pages(rows: np.ndarray, locked: dict) -> None:
    """Page-lock (``cudaHostRegister``) the host array that ``rows`` views,
    once, keeping it in ``locked`` by address; a copy to the card from it is
    then a DMA transfer. Where CUDA refuses, the copy stays pageable."""
    owner = rows
    while isinstance(owner.base, np.ndarray):
        owner = owner.base
    ptr = owner.ctypes.data
    if ptr in locked:
        return
    try:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(ptr, owner.nbytes, 0))
    except RuntimeError:
        owner = None
    locked[ptr] = owner


def _unlock_pages(locked: dict) -> None:
    for ptr, owner in locked.items():
        if owner is not None:
            torch.cuda.cudart().cudaHostUnregister(ptr)
    locked.clear()


class Sharded:
    """Each range shard answered by the plain reference under the one family
    and the per-shard S budget max(4k, ceil(S / shards)), then merged as the
    sharded plan merges: squared distances in shard order, a stable sort,
    the first k; I/O counters summed, ``found`` on any shard, the radii the
    deepest. The database moves to ``device``, and one shard's tables are
    held there at a time. ``precision`` is the shards' (``"tf32"`` for the
    control)."""

    def __init__(self, cfg, db, family_seed, shards, device, precision="float64"):
        p = RefParams.from_config(cfg)
        family = family_from_seed(family_seed, p)
        db = db.to(device)
        whole = Reference(db, family, p)
        self.db, self.dev, self.db_norm = whole.db, whole.dev, whole.db_norm
        self.exact_d2 = whole.exact_d2
        self.k = p.k
        part = dataclasses.replace(p, S=max(4 * p.k, -(-p.S // shards)))
        bounds = np.linspace(0, db.shape[0], shards + 1).astype(np.int64)
        self.parts = [(int(lo), Reference(db[lo:hi], family, part, precision=precision))
                      for lo, hi in zip(bounds[:-1], bounds[1:])]

    def answer(self, queries):
        got = [(lo, ref.answer(queries)) for lo, ref in self.parts]
        ids = torch.cat([torch.where(a.ids == INVALID, INVALID, a.ids + lo)
                         for lo, a in got], 1)
        d2 = torch.cat([a.d2 for _, a in got], 1)
        order = torch.sort(d2, dim=1, stable=True).indices[:, :self.k]
        res = [a for _, a in got]

        def total(name):
            return sum(getattr(a, name) for a in res)

        def anyof(name):
            return torch.stack([getattr(a, name) for a in res]).any(0)

        return RefResult(ids=torch.gather(ids, 1, order), d2=torch.gather(d2, 1, order),
                         found=anyof("found"),
                         radii_searched=torch.stack([a.radii_searched for a in res]).amax(0),
                         nio_table=total("nio_table"), nio_blocks=total("nio_blocks"),
                         cands_checked=total("cands_checked"), ambiguous=anyof("ambiguous"),
                         active=anyof("active"), blocks=total("blocks"), cands=total("cands"))


def reference(cfg, db, family_seed, device, layout, precision="float64"):
    return Sharded(cfg, db, family_seed, int(cfg["shards"]), device, precision)
