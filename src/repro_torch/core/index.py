"""E2LSHoS index construction on the device (paper Sec. 5.3 layout).

Storage-tier layout (paper Secs. 5.1/5.3):
  * a hash table per (radius t, table l): 2^u buckets -> the head of the
    bucket's block chain, plus the bucket size;
  * bucket blocks of ``block_objs`` object infos (512 B blocks: 16 B header
    + 99 x 5 B infos), chained until the bucket is exhausted;
  * object info = object id + fingerprint (paper Sec. 5.2).

The index's native representation is ``IndexArrays``: the block store as
[NB, BLKp] rows with per-bucket head rows (what the fused plan reads), plus
the flat CSR view (``table_off``/``table_cnt`` over ``entries_*``) that the
oracle plan and the N_io replay read. Both hold the same entries in the same
chunk order. A bucket's chunks are consecutive rows (block j is row
``head + j``), so walking a chain is an offset computation.

The build runs on the index's device: float64 projections, one stable sort
per radius in place of the reference's per-table ``np.argsort``, CSR
offsets by one cumulative sum, and blockification by one scatter. Given the
same family and ``lane_pad`` it yields the reference's leaves exactly.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np
import torch

from .hashing import HashFamily, hash_points_radius_deterministic, make_hash_family
from .probabilities import LSHParams
from ..kernels.bucket_probe.ops import blockify_entries
from ..kernels.dispatch import native_lane_pad, resolve_device

__all__ = ["IndexArrays", "IndexStats", "E2LSHIndex", "build_index"]


def _norm2(db: np.ndarray) -> np.ndarray:
    """||x||^2 per row with numpy's float32 summation (the reference's exact
    values; torch sums in another order)."""
    return np.sum(np.asarray(db, np.float32) ** 2, axis=-1, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class IndexArrays:
    """The index's tensors, all on one device.

    Layout groups:
      hash family      a [r, L, m, d] f32, b [r, L, m] f32,
                       rm [r, L, m] i32 (uint32 bit patterns)
      block store      ids_blocks/fps_blocks [NB, BLKp] i32 (row 0 is an
                       empty spare used as safe padding),
                       blocks_head [r, L, 2^u] i32 (-1 empty)
      CSR view         table_off/table_cnt [r, L, 2^u] i32 (off -1 empty)
                       over entries_id [E] i32 / entries_fp [E] i32
      DRAM tier        db [n, d] f32, db_norm2 [n] f32

    ``entries_fp`` is widened from the reference's uint16 to int32 (torch's
    uint16 supports few operations); ``to_numpy`` restores the reference's
    dtypes.
    """

    a: torch.Tensor
    b: torch.Tensor
    rm: torch.Tensor
    ids_blocks: torch.Tensor
    fps_blocks: torch.Tensor
    blocks_head: torch.Tensor
    table_off: torch.Tensor
    table_cnt: torch.Tensor
    entries_id: torch.Tensor
    entries_fp: torch.Tensor
    db: torch.Tensor
    db_norm2: torch.Tensor
    block_objs: int
    lane_pad: int

    @staticmethod
    def array_fields() -> tuple:
        return tuple(f.name for f in dataclasses.fields(IndexArrays)
                     if f.name not in ("block_objs", "lane_pad"))

    @property
    def device(self) -> torch.device:
        return self.db.device

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in self.array_fields())

    def to(self, device) -> "IndexArrays":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in self.array_fields()})

    @staticmethod
    def from_csr(*, a, b, rm, table_off, table_cnt, entries_id, entries_fp, db,
                 db_norm2, block_objs: int, lane_pad: int) -> "IndexArrays":
        """Blockify a CSR layout (tensors on one device) into the native
        block-store representation."""
        ids_b, fps_b, head, _ = blockify_entries(
            entries_id, entries_fp, table_off, table_cnt, int(block_objs),
            lane_pad=int(lane_pad))
        return IndexArrays(
            a=a, b=b, rm=rm, ids_blocks=ids_b, fps_blocks=fps_b, blocks_head=head,
            table_off=table_off.to(torch.int32), table_cnt=table_cnt.to(torch.int32),
            entries_id=entries_id.to(torch.int32), entries_fp=entries_fp.to(torch.int32),
            db=db, db_norm2=db_norm2, block_objs=int(block_objs),
            lane_pad=int(lane_pad))

    @staticmethod
    def from_numpy(leaves: dict, *, block_objs: int, lane_pad: int,
                   device) -> "IndexArrays":
        """Carry an index across from numpy leaves keyed by field name (for the
        reference: ``np.asarray(getattr(ix, name))`` for each of
        ``array_fields()``). The uint32 multipliers become int32 bit
        patterns and the uint16 fingerprints int32; everything else keeps
        its dtype."""
        missing = set(IndexArrays.array_fields()) - set(leaves)
        if missing:
            raise ValueError(f"missing index leaves: {sorted(missing)}")
        dev = torch.device(device)

        def conv(name):
            arr = np.asarray(leaves[name])
            if name == "rm":
                arr = arr.astype(np.uint32).view(np.int32)
            elif name == "entries_fp":
                arr = arr.astype(np.int32)
            return torch.from_numpy(np.array(arr, order="C")).to(dev)

        return IndexArrays(**{f: conv(f) for f in IndexArrays.array_fields()},
                           block_objs=int(block_objs), lane_pad=int(lane_pad))

    def leaf_numpy(self, name: str) -> np.ndarray:
        """One leaf as a numpy array in the reference's dtype (rm uint32,
        entries_fp uint16, the rest as held)."""
        arr = getattr(self, name).cpu().numpy()
        if name == "rm":
            return arr.view(np.uint32)
        if name == "entries_fp":
            return arr.astype(np.uint16)
        return arr

    def to_numpy(self) -> dict:
        """The leaves as numpy arrays in the reference's dtypes."""
        return {f: self.leaf_numpy(f) for f in self.array_fields()}

    def spill(self, path, *, params=None, stats=None) -> None:
        """Write this index to ``path`` in the external-memory spill format,
        byte for byte the reference's (``repro_torch.storage.format``).
        ``load_arrays`` round-trips every leaf; ``load_external`` serves the
        file under ``plan="external"`` when ``params`` are given (as
        ``E2LSHIndex.spill`` gives them)."""
        from ..storage.format import spill_index
        spill_index(path, self, params=params, stats=stats)

    def with_block_objs(self, block_objs: int,
                        lane_pad: Optional[int] = None) -> "IndexArrays":
        """Re-blockify under another block size (the timing knob), from the CSR
        view; the same layout returns self."""
        lp = self.lane_pad if lane_pad is None else int(lane_pad)
        if int(block_objs) == self.block_objs and lp == self.lane_pad:
            return self
        return IndexArrays.from_csr(
            a=self.a, b=self.b, rm=self.rm, table_off=self.table_off,
            table_cnt=self.table_cnt, entries_id=self.entries_id,
            entries_fp=self.entries_fp, db=self.db, db_norm2=self.db_norm2,
            block_objs=int(block_objs), lane_pad=lp)


@dataclasses.dataclass
class IndexStats:
    """Build-time statistics (feed Table 6 and the I/O model)."""

    n: int
    entries: int
    nonempty_buckets: int
    storage_blocks: int          # paper-layout 512 B blocks: sum ceil(k / block_objs)
    index_storage_bytes: int     # paper layout: blocks * block_bytes + tables
    table_storage_bytes: int
    dram_index_bytes: int        # non-empty bitmap kept in DRAM (skips empty-bucket I/O)
    db_bytes: int
    max_bucket: int

    def total_storage_bytes(self) -> int:
        return self.index_storage_bytes


@dataclasses.dataclass
class E2LSHIndex:
    params: LSHParams
    family: HashFamily
    arrays: IndexArrays
    stats: IndexStats

    # -- the CSR view by its older names (the reference's legacy fields) ------
    @property
    def table_off(self) -> torch.Tensor:
        return self.arrays.table_off

    @property
    def table_cnt(self) -> torch.Tensor:
        return self.arrays.table_cnt

    @property
    def entries_id(self) -> torch.Tensor:
        return self.arrays.entries_id

    @property
    def entries_fp(self) -> torch.Tensor:
        return self.arrays.entries_fp

    @property
    def db(self) -> torch.Tensor:
        return self.arrays.db

    # A checkpoint holds the CSR view and the layout metadata only, as the
    # reference's does: load() re-derives the block store (blockify_entries
    # reproduces it exactly) and db_norm2. Either package loads the other's.
    _SAVED_FIELDS = ("a", "b", "rm", "table_off", "table_cnt",
                     "entries_id", "entries_fp", "db")

    def save(self, path) -> None:
        """Write an ``.npz`` checkpoint in the reference's layout (reference
        dtypes; params and stats as pickled dicts)."""
        ix = self.arrays
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        stats = None if self.stats is None else dataclasses.asdict(self.stats)
        np.savez_compressed(
            p, **{name: ix.leaf_numpy(name) for name in self._SAVED_FIELDS},
            layout_meta=np.asarray([ix.block_objs, ix.lane_pad], np.int64),
            params=np.array([dataclasses.asdict(self.params)], dtype=object),
            stats=np.array([stats], dtype=object))

    def spill(self, path) -> None:
        """Spill to the external-memory format with params and build stats,
        so ``repro_torch.storage.load_external(path)`` serves the file."""
        self.arrays.spill(path, params=self.params, stats=self.stats)

    @staticmethod
    def load(path, *, device=None) -> "E2LSHIndex":
        """Load an ``.npz`` checkpoint (either package's) onto ``device``
        (None -> cuda), re-blockified at its saved layout. Its params and
        stats are pickled dicts, so load only checkpoints this program or
        the reference wrote."""
        dev = resolve_device(device)
        z = np.load(path, allow_pickle=True)
        pdict = dict(z["params"][0])
        pdict["radii"] = tuple(pdict["radii"])
        params = LSHParams(**pdict)
        sdict = z["stats"][0]
        family = HashFamily.from_numpy(z["a"], z["b"], z["rm"], w=params.w,
                                       u=params.u, fp_bits=params.fp_bits,
                                       device=dev)
        if "layout_meta" not in z.files:
            raise ValueError(f"{path}: checkpoint has no layout_meta "
                             "(block_objs, lane_pad); cannot re-blockify")
        bo, lp = (int(v) for v in z["layout_meta"])
        db = np.ascontiguousarray(z["db"], np.float32)

        def leaf(name, dtype):
            return torch.from_numpy(np.ascontiguousarray(z[name]).astype(dtype)).to(dev)

        arrays = IndexArrays.from_csr(
            a=family.a, b=family.b, rm=family.rm,
            table_off=leaf("table_off", np.int32), table_cnt=leaf("table_cnt", np.int32),
            entries_id=leaf("entries_id", np.int32),
            entries_fp=leaf("entries_fp", np.int32),
            db=torch.from_numpy(db).to(dev),
            db_norm2=torch.from_numpy(_norm2(db)).to(dev), block_objs=bo, lane_pad=lp)
        return E2LSHIndex(params=params, family=family, arrays=arrays,
                          stats=None if sdict is None else IndexStats(**sdict))


def _pack_radius_table(bucket: torch.Tensor, fp: torch.Tensor, u: int):
    """Pack one radius worth of buckets into CSR order.

    bucket/fp [n, L] int32. Entries are ordered by (table l, bucket, object
    id) — the reference's per-table stable argsort — so one stable sort of
    the key l * 2^u + bucket over the table-major flattening gives the order
    for all L tables at once. Returns (toff [L, 2^u] int64 with -1 for
    empty buckets, relative to this radius; tcnt [L, 2^u] int64; ids [n*L];
    fps [n*L]).
    """
    n, L = bucket.shape
    key = ((torch.arange(L, device=bucket.device, dtype=torch.int64)[:, None] << u)
           + bucket.T.to(torch.int64)).reshape(-1)
    _, order = torch.sort(key, stable=True)
    ids = (order % n).to(torch.int32)
    fps = fp.T.reshape(-1)[order]
    tcnt = torch.bincount(key, minlength=L << u)
    toff = torch.where(tcnt > 0, torch.cumsum(tcnt, 0) - tcnt, -1)
    return toff.view(L, 1 << u), tcnt.view(L, 1 << u), ids, fps


def build_index(db, params: LSHParams, *, family: Optional[HashFamily] = None,
                generator: Optional[torch.Generator] = None, device=None,
                lane_pad: Optional[int] = None) -> E2LSHIndex:
    """Build the full multi-radius index (paper Sec. 5.3) on ``device``
    (None -> cuda) and emit it blockified.

    ``family`` injects a hash family (parity tests pass the reference's);
    otherwise one is drawn from ``generator`` (default: seeded with
    ``params.seed``).
    """
    dev = resolve_device(device)
    db_np = np.ascontiguousarray(db.cpu().numpy() if torch.is_tensor(db) else db,
                                 dtype=np.float32)
    n, d = db_np.shape
    if n != params.n or d != params.d:
        raise ValueError(f"db is {db_np.shape}, params expect ({params.n}, {params.d})")
    r, L, m, u, bo = params.r, params.L, params.m, params.u, params.block_objs
    if n * L * r >= 2**31:
        raise ValueError("entry space exceeds int32 addressing; shard the index")
    if family is None:
        if generator is None:
            generator = torch.Generator().manual_seed(params.seed)
        family = make_hash_family(r=r, L=L, m=m, d=d, w=params.w, u=u,
                                  fp_bits=params.fp_bits, generator=generator,
                                  device=dev)
    x = torch.from_numpy(db_np).to(dev)
    rows = max(1024, (128 << 20) // (L * m))  # ~1 GiB of float64 projections

    toff_all, tcnt_all, ids_all, fps_all = [], [], [], []
    for t, radius in enumerate(params.radii):
        parts = [hash_points_radius_deterministic(family, x[s:s + rows], t, float(radius))
                 for s in range(0, n, rows)]
        bucket = torch.cat([p[0] for p in parts])
        fp = torch.cat([p[1] for p in parts])
        del parts
        toff, tcnt, ids, fps = _pack_radius_table(bucket, fp, u)
        toff_all.append(torch.where(toff >= 0, toff + t * n * L, -1))
        tcnt_all.append(tcnt)
        ids_all.append(ids)
        fps_all.append(fps)
    table_off = torch.stack(toff_all).to(torch.int32)
    table_cnt = torch.stack(tcnt_all)
    entries_id = torch.cat(ids_all)
    entries_fp = torch.cat(fps_all)
    del toff_all, ids_all, fps_all

    # Paper-layout storage accounting (Table 6): 512 B blocks + on-storage
    # hash tables (8 B per address entry), plus the DRAM-resident non-empty
    # bitmap that lets a query skip I/O for empty buckets.
    storage_blocks = int(((table_cnt + bo - 1) // bo).sum())
    table_storage = r * L * (1 << u) * 8
    stats = IndexStats(
        n=n, entries=int(entries_id.shape[0]),
        nonempty_buckets=int((table_cnt > 0).sum()),
        storage_blocks=storage_blocks,
        index_storage_bytes=storage_blocks * params.block_bytes + table_storage,
        table_storage_bytes=table_storage,
        dram_index_bytes=(r * L * (1 << u) + 7) // 8,
        db_bytes=int(db_np.nbytes),
        max_bucket=int(table_cnt.max()) if table_cnt.numel() else 0)
    arrays = IndexArrays.from_csr(
        a=family.a, b=family.b, rm=family.rm, table_off=table_off,
        table_cnt=table_cnt.to(torch.int32), entries_id=entries_id,
        entries_fp=entries_fp, db=x,
        db_norm2=torch.from_numpy(_norm2(db_np)).to(dev), block_objs=bo,
        lane_pad=native_lane_pad() if lane_pad is None else int(lane_pad))
    return E2LSHIndex(params=params, family=family, arrays=arrays, stats=stats)
