"""The sharded in-memory plan: the database range-partitioned into shards,
one sub-index per shard under a SHARED hash family, every shard probed and
the shards' top-k merged (counterpart of ``repro.core.distributed``).

The paper runs one node with 1-12 drives (Table 5, Fig. 15: query speed
scales with aggregate IOPS). The reference treats each device's memory as
one drive and runs the shards in parallel under ``shard_map``, merging with
an all-gather over its index axes, and splits the query batch over its query
axes (the paper's multi-threading, Fig. 16). The port has two forms:

* One process: ``sharded_query_result(ShardedIndexArrays, ...)`` loops over
  the shards on one device, runs the plan body on each under one
  ``QueryConfig`` (the per-shard S budget), offsets each shard's ids by its
  base, and merges as the reference's all-gather merge does (the squared
  distances concatenated in shard order, a stable sort, the first k,
  ``sqrt``), so the result is the reference's bit for bit given the same
  per-shard results.
* Ranks: ``torch.distributed`` ranks laid out as an index x query grid
  (``RankLayout``, the reference's ``index_axes`` x ``query_axes``). Each
  index rank builds and holds only its own shard (``build_local_shard``);
  ``sharded_query_result(LocalShard, ..., group=layout)`` splits the batch
  evenly over the query groups (padding rows masked), runs the same body
  on the rank's shard, all-gathers every shard's part over the shard group
  in shard order, merges it with the one-process merge, and all-gathers the
  rows over the query group. The result is the one-process result bit for
  bit. Every rank of the layout makes every call (a collective).

Layout: ``ShardedIndexArrays.arrays`` is a tuple of per-shard
``IndexArrays``, each at its own extent, which share the family tensors
``a``/``b``/``rm``. The reference stacks the shards into one padded array
per leaf, which ``shard_map`` needs and a loop does not;
``ShardedIndexArrays.from_numpy`` strips such a stack to the per-shard
data. The reference's ``specs()`` (``PartitionSpec``s for ``shard_map``)
has no torch counterpart and is left out.

Per-shard candidate budget: the paper examines S candidates per (R, c)-NN;
with SH shards the default is ``max(4k, ceil(S / SH))`` per shard, so the
aggregate work matches the single-node algorithm (``s_cap_per_shard``
overrides it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .hashing import make_hash_family
from .index import IndexArrays, build_index
from .probabilities import LSHParams, solve_params
from .query import QueryConfig, QueryResult, fused_plan_body, oracle_plan_body
from ..kernels.bucket_probe.ops import INVALID
from ..kernels.dispatch import resolve_device
from ..telemetry import get_registry, get_tracer

__all__ = ["ShardedIndexArrays", "build_sharded_index", "sharded_query_result",
           "make_sharded_query_fn", "RankLayout", "LocalShard", "build_local_shard"]

_FAMILY = ("a", "b", "rm")

_GATHER_BYTES = get_registry().counter(
    "e2lsh_sharded_gather_bytes_total",
    "bytes the rank-parallel sharded plan's all-gathers bring to this rank")


@dataclasses.dataclass
class ShardedIndexArrays:
    """Per-shard index tensors on one device: ``arrays[s]`` indexes database
    rows ``shard_offsets[s]`` .. ``shard_offsets[s+1]`` (the last up to
    ``params.n``) by their local ids; every shard shares one family."""

    arrays: tuple          # per-shard IndexArrays (a/b/rm tensors shared)
    shard_offsets: tuple   # global id base per shard (ints)
    params: LSHParams
    num_shards: int

    @property
    def block_objs(self) -> int:
        return self.arrays[0].block_objs

    @property
    def lane_pad(self) -> int:
        return self.arrays[0].lane_pad

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    def nbytes(self) -> int:
        """Device bytes of every shard, the shared family counted once."""
        fam = sum(getattr(self.arrays[0], f).nbytes for f in _FAMILY)
        return sum(ix.nbytes() - fam for ix in self.arrays) + fam

    def to(self, device) -> "ShardedIndexArrays":
        device = torch.device(device)
        if device == self.device:
            return self
        fam = {f: getattr(self.arrays[0], f).to(device) for f in _FAMILY}
        arrays = tuple(dataclasses.replace(
            ix, **fam, **{f: getattr(ix, f).to(device) for f in ix.array_fields()
                          if f not in _FAMILY}) for ix in self.arrays)
        return dataclasses.replace(self, arrays=arrays)

    def with_block_objs(self, block_objs: int,
                        lane_pad: Optional[int] = None) -> "ShardedIndexArrays":
        """Re-blockify every shard's block store from its CSR view at a new
        block size (the timing knob); the same layout returns self."""
        lp = self.lane_pad if lane_pad is None else int(lane_pad)
        if int(block_objs) == self.block_objs and lp == self.lane_pad:
            return self
        return dataclasses.replace(self, arrays=tuple(
            ix.with_block_objs(int(block_objs), lp) for ix in self.arrays))

    def to_global(self) -> IndexArrays:
        """The ONE global index this sharded build partitions, on the shards'
        device.

        Every shard hashes with the shared family and the partition is by
        range, so a global bucket's entries are its per-shard entries
        concatenated in shard order (ascending global id, the order a single
        ``build_index(db, params, family=family)`` packs). The result is
        re-blockified by ``IndexArrays.from_csr``: the global chain-block
        layout, which is not the per-shard one
        (``sum(ceil(cnt_s/BLK)) != ceil(cnt/BLK)``); that is the index
        ``spill`` stripes. Leaf for leaf the reference's ``to_global()``.
        """
        ix0 = self.arrays[0]
        dev = ix0.device
        cnt = torch.stack([ix.table_cnt for ix in self.arrays]).to(torch.int64)
        gcnt = cnt.sum(dim=0)                    # [r, L, 2^u]
        flat = gcnt.reshape(-1)
        goff = torch.cumsum(flat, 0) - flat
        gid = torch.zeros(int(flat.sum()), dtype=torch.int32, device=dev)
        gfp = torch.zeros_like(gid)
        before = torch.cumsum(cnt, dim=0) - cnt  # earlier shards' entries a bucket
        for s, ix in enumerate(self.arrays):
            c = cnt[s].reshape(-1)
            nz = torch.nonzero(c > 0).squeeze(1)
            if nz.numel() == 0:
                continue
            reps = c[nz]
            total = int(reps.sum())
            # per-bucket ramp 0..cnt-1 without a loop over buckets
            ramp = (torch.arange(total, dtype=torch.int64, device=dev)
                    - torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps,
                                              output_size=total))
            src = torch.repeat_interleave(ix.table_off.reshape(-1)[nz].to(torch.int64),
                                          reps, output_size=total) + ramp
            dst = torch.repeat_interleave(goff[nz] + before[s].reshape(-1)[nz], reps,
                                          output_size=total) + ramp
            gid[dst] = ix.entries_id[src] + int(self.shard_offsets[s])
            gfp[dst] = ix.entries_fp[src]
        toff = torch.where(flat > 0, goff, -1).reshape(gcnt.shape).to(torch.int32)
        return IndexArrays.from_csr(
            a=ix0.a, b=ix0.b, rm=ix0.rm, table_off=toff, table_cnt=gcnt.to(torch.int32),
            entries_id=gid, entries_fp=gfp,
            db=torch.cat([ix.db for ix in self.arrays]),
            db_norm2=torch.cat([ix.db_norm2 for ix in self.arrays]),
            block_objs=self.block_objs, lane_pad=self.lane_pad)

    def spill(self, path, *, params=None, stats=None) -> dict:
        """Write this sharded index as a sharded spill directory: the GLOBAL
        index's block store striped round-robin over ``num_shards`` files
        (``repro_torch.storage.spill_index_sharded``, byte for byte the
        reference's). ``load_external_sharded(path)`` serves it under
        ``plan="sharded_external"``, bit-exact with ``plan="fused"`` over
        ``to_global()``. Returns the manifest payload."""
        from ..storage.format import spill_index_sharded
        return spill_index_sharded(
            path, self.to_global(), self.num_shards,
            params=params if params is not None else self.params, stats=stats)

    @staticmethod
    def from_numpy(leaves: dict, *, shard_offsets, params: LSHParams,
                   block_objs: int, lane_pad: int, device) -> "ShardedIndexArrays":
        """Carry the reference's sharded index across: ``leaves`` keyed by
        field name, ``a``/``b``/``rm`` replicated and every other leaf
        stacked [SH, ...] and padded to the largest shard
        (``np.asarray(getattr(sh.arrays, name))``). Each shard is stripped
        to its own extent: n_s db rows, ``sum(table_cnt[s])`` entries and
        ``1 + sum(ceil(table_cnt[s] / block_objs))`` block rows."""
        offs = [int(o) for o in np.asarray(shard_offsets)]
        bounds = offs + [int(params.n)]
        fam = {f: leaves[f] for f in _FAMILY}
        arrays = []
        for s in range(len(offs)):
            cnt = np.asarray(leaves["table_cnt"][s], np.int64)
            n_s, e_s = bounds[s + 1] - bounds[s], int(cnt.sum())
            nb_s = 1 + int(((cnt + block_objs - 1) // block_objs).sum())
            rows = dict(db=n_s, db_norm2=n_s, entries_id=e_s, entries_fp=e_s,
                        ids_blocks=nb_s, fps_blocks=nb_s)
            shard = {f: (np.asarray(leaves[f][s])[:rows[f]] if f in rows
                         else np.asarray(leaves[f][s]))
                     for f in IndexArrays.array_fields() if f not in _FAMILY}
            arrays.append(IndexArrays.from_numpy({**fam, **shard}, block_objs=block_objs,
                                                 lane_pad=lane_pad, device=device))
        shared = {f: getattr(arrays[0], f) for f in _FAMILY}
        return ShardedIndexArrays(
            arrays=tuple(dataclasses.replace(ix, **shared) for ix in arrays),
            shard_offsets=tuple(offs), params=params, num_shards=len(offs))


def _shard_plan(db, num_shards: int, *, c, w, gamma, s_scale, seed, max_L, u_bits,
                device):
    """What every shard's build shares: the host database (float32), the
    range bounds, the parameters and the family. The parameters follow the
    GLOBAL n and x_max (paper Eq. 5: the sublinearity is in the whole
    database's size); the table width ``u`` follows the largest shard. The
    family is drawn from a CPU generator seeded ``seed``, so every process
    draws the same one."""
    db = np.ascontiguousarray(db.cpu().numpy() if torch.is_tensor(db) else db,
                              dtype=np.float32)
    n, d = db.shape
    bounds = np.linspace(0, n, num_shards + 1).astype(np.int64)
    n_shard_max = int(np.max(np.diff(bounds)))
    params = solve_params(
        n, d, c=c, w=w, gamma=gamma, x_max=float(np.abs(db).max()), seed=seed,
        s_scale=s_scale, max_L=max_L,
        u_bits=u_bits if u_bits is not None
        else max(8, int(math.floor(math.log2(max(n_shard_max, 256)))) - 1))
    family = make_hash_family(r=params.r, L=params.L, m=params.m, d=d, w=params.w,
                              u=params.u, fp_bits=params.fp_bits,
                              generator=torch.Generator().manual_seed(seed), device=device)
    return db, bounds, params, family


def _build_shard(db, bounds, params, family, s: int, device) -> IndexArrays:
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    return build_index(db[lo:hi], dataclasses.replace(params, n=hi - lo), family=family,
                       device=device).arrays


def build_sharded_index(db, num_shards: int, *, c: float = 2.0, w: float = 4.0,
                        gamma: float = 1.0, s_scale: float = 1.0, seed: int = 0,
                        max_L: int = 64, u_bits: Optional[int] = None,
                        device=None) -> ShardedIndexArrays:
    """Range-partition ``db`` into ``num_shards`` shards and build one
    sub-index per shard on ``device`` (None -> cuda) under one family drawn
    from ``seed``. The parameters follow the GLOBAL n; the table width ``u``
    follows the largest shard."""
    dev = resolve_device(device)
    db, bounds, params, family = _shard_plan(
        db, num_shards, c=c, w=w, gamma=gamma, s_scale=s_scale, seed=seed, max_L=max_L,
        u_bits=u_bits, device=dev)
    arrays = tuple(_build_shard(db, bounds, params, family, s, dev)
                   for s in range(num_shards))
    return ShardedIndexArrays(arrays=arrays,
                              shard_offsets=tuple(int(b) for b in bounds[:-1]),
                              params=params, num_shards=num_shards)


# --------------------------------------------------------------------------
# Ranks: one shard a rank, the merge through torch.distributed
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Where this process sits in a grid of ``shards`` x ``query_groups``
    ranks (the reference's ``index_axes`` x ``query_axes``).

    The grid's position p = shard * query_groups + query holds global rank
    ``ranks[p]`` (ascending). ``shard_group`` holds the ranks of this rank's
    query group, one a shard: ``torch.distributed`` orders a group by global
    rank, which here is shard order, so an all-gather over it comes back in
    the merge's order. ``query_group`` holds the ranks of this rank's shard,
    one a query group. ``group`` is the whole grid (None: it is the default
    group). A group of one rank is None: no collective runs over it."""

    shards: int
    query_groups: int
    position: int
    ranks: tuple
    group: Any = None
    shard_group: Any = None
    query_group: Any = None

    @property
    def shard(self) -> int:
        return self.position // self.query_groups

    @property
    def query(self) -> int:
        return self.position % self.query_groups

    @property
    def leader(self) -> int:
        """The global rank at position 0 (the one that drives a queue)."""
        return self.ranks[0]

    @staticmethod
    def make(shards: int, query_groups: int = 1, *, ranks=None) -> Optional["RankLayout"]:
        """Lay the ranks ``ranks`` (default: every rank of the initialized
        default group) out as a ``shards`` x ``query_groups`` grid. Every
        rank of the default group calls this, in the same order as its other
        group creations (``new_group`` is collective); a rank outside
        ``ranks`` gets None."""
        world, me = dist.get_world_size(), dist.get_rank()
        ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
        if len(ranks) != shards * query_groups:
            raise ValueError(f"{len(ranks)} ranks cannot form a {shards} x {query_groups} "
                             "grid of index x query ranks")
        if list(ranks) != sorted(set(ranks)) or ranks[-1] >= world:
            raise ValueError(f"ranks {ranks} must be ascending, distinct and < {world}")
        whole = None if len(ranks) == world else dist.new_group(list(ranks))
        by_query = [dist.new_group([ranks[s * query_groups + q] for s in range(shards)])
                    if shards > 1 else None for q in range(query_groups)]
        by_shard = [dist.new_group([ranks[s * query_groups + q] for q in range(query_groups)])
                    if query_groups > 1 else None for s in range(shards)]
        if me not in ranks:
            return None
        p = ranks.index(me)
        return RankLayout(shards=shards, query_groups=query_groups, position=p, ranks=ranks,
                          group=whole, shard_group=by_query[p % query_groups],
                          query_group=by_shard[p // query_groups])


@dataclasses.dataclass
class LocalShard:
    """One index rank's part of a sharded index: the sub-index of database
    rows ``shard_offset`` .. ``shard_offset + n_s`` (local ids), built as
    shard ``shard`` of ``build_sharded_index`` is, under the GLOBAL
    ``params``."""

    arrays: IndexArrays
    shard: int
    shard_offset: int
    params: LSHParams
    num_shards: int

    @property
    def block_objs(self) -> int:
        return self.arrays.block_objs

    @property
    def device(self) -> torch.device:
        return self.arrays.device

    def nbytes(self) -> int:
        return self.arrays.nbytes()

    def to(self, device) -> "LocalShard":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, arrays=self.arrays.to(device))

    def with_block_objs(self, block_objs: int,
                        lane_pad: Optional[int] = None) -> "LocalShard":
        arrays = self.arrays.with_block_objs(int(block_objs), lane_pad)
        return self if arrays is self.arrays else dataclasses.replace(self, arrays=arrays)


def build_local_shard(db, num_shards: int, shard: int, *, c: float = 2.0, w: float = 4.0,
                      gamma: float = 1.0, s_scale: float = 1.0, seed: int = 0,
                      max_L: int = 64, u_bits: Optional[int] = None,
                      device=None) -> LocalShard:
    """Shard ``shard`` of ``build_sharded_index(db, num_shards, ...)``, built
    alone on ``device`` (None -> cuda): every rank holds the host database
    (the parameters follow its global n and x_max), draws the same family
    and keeps only its own range on the device. Leaf for leaf the
    one-process build's shard."""
    dev = resolve_device(device)
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} of {num_shards}")
    db, bounds, params, family = _shard_plan(
        db, num_shards, c=c, w=w, gamma=gamma, s_scale=s_scale, seed=seed, max_L=max_L,
        u_bits=u_bits, device=dev)
    return LocalShard(arrays=_build_shard(db, bounds, params, family, shard, dev),
                      shard=shard, shard_offset=int(bounds[shard]), params=params,
                      num_shards=num_shards)


def _shard_config(sharded, k: int, s_cap, s_cap_per_shard) -> QueryConfig:
    """The per-shard schedule both local plans read, chunked as the arrays
    are blockified."""
    p = sharded.params
    base_S = int(s_cap or p.S)
    cap = s_cap_per_shard or max(4 * k, -(-base_S // sharded.num_shards))
    bo = sharded.block_objs
    return QueryConfig.from_params(p, k=k).replace(
        s_cap=int(cap), block_objs=(bo if bo != p.block_objs else None))


def _shard_part(body, ix: IndexArrays, offset: int, queries, cfg, valid) -> QueryResult:
    """One shard's contribution to the merge: its result with global ids
    (INVALID kept) and SQUARED distances in ``dists`` (inf kept)."""
    res = body(ix, queries, cfg, valid)
    return dataclasses.replace(
        res, ids=torch.where(res.ids == INVALID, INVALID, res.ids + int(offset)),
        dists=torch.where(torch.isinf(res.dists), torch.inf, res.dists ** 2))


def _merge(parts, k: int) -> QueryResult:
    """The reference's all-gather merge over shard parts in shard order:
    candidates concatenated, a stable sort, the first k, ``sqrt``. I/O
    counters are summed (paper Fig. 15: the total I/O observed), ``found``
    is any shard's success, ``radii_searched`` the deepest schedule any
    shard walked."""
    all_ids = torch.cat([r.ids for r in parts], dim=1)
    all_d2 = torch.cat([r.dists for r in parts], dim=1)
    order = torch.sort(all_d2, dim=1, stable=True).indices[:, :k]
    first = parts[0]
    nio_t, nio_b, cands = first.nio_table, first.nio_blocks, first.cands_checked
    found, radii = first.found, first.radii_searched
    for r in parts[1:]:
        nio_t, nio_b = nio_t + r.nio_table, nio_b + r.nio_blocks
        cands = cands + r.cands_checked
        found = found | r.found
        radii = torch.maximum(radii, r.radii_searched)
    return QueryResult(ids=torch.gather(all_ids, 1, order),
                       dists=torch.sqrt(torch.gather(all_d2, 1, order)),
                       found=found, radii_searched=radii, nio_table=nio_t,
                       nio_blocks=nio_b, cands_checked=cands, probe_sizes=None)


def _all_gather(packed: torch.Tensor, group, size: int) -> list:
    parts = [torch.empty_like(packed) for _ in range(size)]
    dist.all_gather(parts, packed, group=group)
    return parts


def _gathered(part: QueryResult, group, size: int) -> list:
    """Every rank's ``part`` in ``group`` (rank order): packed into one int32
    tensor, all-gathered, unpacked. With tracing on, the ``query.gather``
    span; the bytes gathered count in ``e2lsh_sharded_gather_bytes_total``."""
    with get_tracer().span("query.gather"):
        packed = part._packed()
        _GATHER_BYTES.inc(size * packed.numel() * packed.element_size())
        return [part._unpacked(p) for p in _all_gather(packed, group, size)]


def _rank_query(local: LocalShard, queries, cfg, valid, layout: RankLayout, body,
                k: int) -> QueryResult:
    """The rank-parallel body: this rank's rows of the batch on its shard,
    the merge over the shard group, the rows over the query group. With
    tracing on, each all-gather is a ``query.gather`` span and the merge the
    ``query.shard_merge`` span."""
    if local.shard != layout.shard or local.num_shards != layout.shards:
        raise ValueError(f"shard {local.shard} of {local.num_shards} on the rank at "
                         f"shard {layout.shard} of {layout.shards}")
    Q, qg = queries.shape[0], layout.query_groups
    rows = -(-Q // qg)
    if valid is None:
        valid = torch.ones((Q,), dtype=torch.bool, device=queries.device)
    if rows * qg != Q:      # a ragged batch: masked padding rows, stripped below
        pad = rows * qg - Q
        queries = torch.cat([queries, queries.new_zeros((pad, queries.shape[1]))])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    lo = layout.query * rows
    part = _shard_part(body, local.arrays, local.shard_offset, queries[lo:lo + rows], cfg,
                       valid[lo:lo + rows])
    parts = ([part] if layout.shards == 1
             else _gathered(part, layout.shard_group, layout.shards))
    with get_tracer().span("query.shard_merge"):
        part = _merge(parts, k)
    if qg > 1:
        groups = _gathered(part, layout.query_group, qg)
        part = QueryResult(**{f.name: None if getattr(part, f.name) is None
                              else torch.cat([getattr(g, f.name) for g in groups])
                              for f in dataclasses.fields(QueryResult)})
    return part.slice_rows(0, Q)


def sharded_query_result(sharded, queries, *, k: int = 1,
                         s_cap: Optional[int] = None,
                         s_cap_per_shard: Optional[int] = None,
                         local_plan: str = "fused", valid=None,
                         group: Optional[RankLayout] = None) -> QueryResult:
    """Query every shard and merge.

    ``sharded`` is a ``ShardedIndexArrays`` (one process: the shards in
    turn on their device) or, with ``group`` (a ``RankLayout``), this rank's
    ``LocalShard``: then every rank of the layout calls with the same
    queries and gets the same result, the one-process result bit for bit.
    ``local_plan="fused"`` runs ``fused_plan_body`` on each shard's block
    store (``SearchEngine``'s ``plan="sharded"``); ``"oracle"`` runs
    ``oracle_plan_body`` through the same merge (the sharded plan's parity
    target). ``probe_sizes`` is not collected. ``valid`` [Q] bool masks
    padded serving rows, inert on every shard.
    """
    if local_plan not in ("fused", "oracle"):
        raise ValueError(f"unknown local_plan {local_plan!r}")
    if (group is not None) != isinstance(sharded, LocalShard):
        raise ValueError("a LocalShard is queried with group= (its RankLayout), a "
                         "ShardedIndexArrays without")
    cfg = _shard_config(sharded, k, s_cap, s_cap_per_shard)
    dev = sharded.device
    if not torch.is_tensor(queries):
        queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    queries = queries.to(dev, torch.float32)
    if valid is not None:
        valid = torch.as_tensor(valid).to(dev, torch.bool)
    body = fused_plan_body if local_plan == "fused" else oracle_plan_body
    if group is not None:
        return _rank_query(sharded, queries, cfg, valid, group, body, k)
    return _merge([_shard_part(body, ix, off, queries, cfg, valid)
                   for ix, off in zip(sharded.arrays, sharded.shard_offsets)], k)


def make_sharded_query_fn(sharded, *, group: Optional[RankLayout] = None, **kw):
    """``fn(queries, valid=None) -> QueryResult``: ``sharded_query_result``
    with ``group`` and ``kw`` (k, s_cap, s_cap_per_shard, local_plan) bound."""
    def fn(queries, valid=None):
        return sharded_query_result(sharded, queries, valid=valid, group=group, **kw)
    return fn
