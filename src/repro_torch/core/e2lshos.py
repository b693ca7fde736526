"""E2LSH-on-Storage facade: build / query / account, in one object.

Modes
-----
* ``tier="storage"`` — E2LSHoS (paper Sec. 5): hash tables + bucket blocks on
  the storage tier, coordinates in DRAM; queries count I/Os.
* ``tier="memory"`` — the in-memory E2LSH baseline: the same algorithm and
  results; the accounting reports no storage I/O and a DRAM footprint that
  includes the whole index (Table 6 / Sec. 4.5).

The executable data structures are the same in both modes (here they live
in the card's memory); what differs is the accounting and the modeled query
time, as in the paper's Sec. 4 analysis framework.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .index import E2LSHIndex, build_index
from .probabilities import LSHParams, solve_params
from .query import QueryResult, SearchEngine
from . import storage as storage_mod
from ..kernels.dispatch import resolve_device

__all__ = ["E2LSHoS", "MemoryFootprint", "MeasuredQuery", "measured_query"]


@dataclasses.dataclass
class MemoryFootprint:
    """Table-6-style accounting, bytes."""

    index_on_storage: int
    dram_usage: int
    dram_index_part: int
    db_bytes: int


@dataclasses.dataclass
class MeasuredQuery:
    result: QueryResult
    t_compute_per_query: float   # measured wall time / Q on the index's device
    nio_mean: float
    cands_mean: float
    radii_mean: float


class E2LSHoS:
    """High-level index: ``E2LSHoS.build(db, ...)`` then ``.query(qs, k=...)``."""

    def __init__(self, index: E2LSHIndex, tier: str = "storage"):
        if tier not in ("storage", "memory"):
            raise ValueError(f"tier must be 'storage' or 'memory', got {tier!r}")
        self.index = index
        self.tier = tier
        self._engine: Optional[SearchEngine] = None

    @staticmethod
    def build(db, *, c: float = 2.0, w: float = 4.0, gamma: float = 1.0,
              s_scale: float = 1.0, tier: str = "storage",
              params: Optional[LSHParams] = None, seed: int = 0, max_m: int = 64,
              max_L: int = 256, u_bits: Optional[int] = None,
              block_bytes: int = 512, device=None) -> "E2LSHoS":
        """Solve the parameters for ``db`` (unless given) and build the index
        on ``device`` (None -> cuda), hash family drawn from ``seed``."""
        dev = resolve_device(device)
        db = np.asarray(db.cpu() if torch.is_tensor(db) else db)
        n, d = db.shape
        if params is None:
            params = solve_params(
                n, d, c=c, w=w, gamma=gamma, x_max=float(np.abs(db).max()),
                seed=seed, s_scale=s_scale, max_m=max_m, max_L=max_L,
                u_bits=u_bits, block_bytes=block_bytes)
        index = build_index(db, params, device=dev,
                            generator=torch.Generator().manual_seed(seed))
        return E2LSHoS(index, tier=tier)

    @property
    def params(self) -> LSHParams:
        return self.index.params

    @property
    def engine(self) -> SearchEngine:
        """The query engine over this index, on the index's device."""
        if self._engine is None:
            self._engine = SearchEngine(self.index, device=self.index.arrays.device)
        return self._engine

    def query(self, queries, *, k: int = 1, plan: Optional[str] = None,
              collect_probe_sizes: bool = False, s_cap: Optional[int] = None,
              block_objs: Optional[int] = None, valid=None) -> QueryResult:
        """Run a query batch through the SearchEngine (plan "fused" by
        default, "host" or "oracle")."""
        return self.engine.query(queries, plan=plan, k=k,
                                 collect_probe_sizes=collect_probe_sizes,
                                 s_cap=s_cap, block_objs=block_objs, valid=valid)

    def footprint(self) -> MemoryFootprint:
        st = self.index.stats
        if self.tier == "storage":
            dram_index, on_storage = st.dram_index_bytes, st.index_storage_bytes
        else:
            dram_index, on_storage = st.index_storage_bytes, 0
        return MemoryFootprint(index_on_storage=on_storage,
                               dram_usage=st.db_bytes + dram_index,
                               dram_index_part=dram_index, db_bytes=st.db_bytes)

    def modeled_time(self, t_compute: float, nio: float,
                     cfg: storage_mod.StorageConfig, *, async_io: bool = True) -> float:
        """Eq. 6/7 external-memory query time for a measured compute time."""
        if self.tier == "memory":
            return t_compute
        fn = storage_mod.t_async if async_io else storage_mod.t_sync
        return fn(t_compute, nio, cfg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measured_query(idx: E2LSHoS, queries, *, k: int = 1, repeats: int = 3,
                   collect_probe_sizes: bool = False,
                   block_objs: Optional[int] = None,
                   plan: Optional[str] = None) -> MeasuredQuery:
    """Run a query plan and measure wall time per query on the index's
    device. The first call warms up (kernel loading, allocator); the repeats
    after it are timed, each ending in a device synchronize."""
    dev = idx.index.arrays.device
    kw = dict(k=k, collect_probe_sizes=collect_probe_sizes,
              block_objs=block_objs, plan=plan)
    res = idx.query(queries, **kw)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = idx.query(queries, **kw)
        _sync(dev)
    dt = (time.perf_counter() - t0) / repeats / len(queries)
    return MeasuredQuery(
        result=res, t_compute_per_query=dt,
        nio_mean=float(res.nio.float().mean()),
        cands_mean=float(res.cands_checked.float().mean()),
        radii_mean=float(res.radii_searched.float().mean()))
