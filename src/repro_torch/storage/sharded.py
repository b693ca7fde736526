"""``plan="sharded_external"``: one global index, block store striped over
per-shard spill files — the paper's multi-drive configuration (Sec. 7,
Fig. 15/16: hash tables stay resident, bucket blocks distribute over 1-12
drives, and query speed scales with the AGGREGATE IOPS the drives serve).

The design decision that makes the plan exact: sharding happens BELOW the
query algorithm, at the block-store row level. Candidate selection —
hashing, table lookups, chain walks, S-cap appends, distance epilogues —
is literally :func:`repro_torch.storage.external.external_plan` on the one global
index, so the bit-exactness contract with ``plan="fused"`` is inherited
verbatim. What the stripe changes is only WHERE a logical block row is
served from: global row ``g`` lives on shard ``g % num_shards`` at local
row ``g // num_shards`` (round-robin by row, the manifest records the
policy). Each shard runs its own backend store — own cache arena, own
pread/uring queue, own :class:`~repro_torch.storage.blockstore.StoreStats`
ledger — and the :class:`StripedBlockStore` rolls the per-shard ledgers up
into the one logical ledger the Eq. 6/7 measured-vs-replay tie-out reads.
Because every logical read maps to exactly one shard, the roll-up is exact:
``sum(per-shard reads) == measured N_io == replay N_io``.

Contrast with ``plan="sharded"`` (core.distributed): that plan partitions
the DATABASE and builds an independent sub-index per device (per-shard S
budgets, merged top-k) — the right shape for HBM-resident multi-device
serving, but its per-shard chain-block boundaries differ from the global
index's (``sum(ceil(cnt_s/BLK)) != ceil(cnt/BLK)``), so it cannot be
bit-exact with the single fused plan nor tie out block-for-block against
the global replay. The striped plan is the storage-tier composition the
paper actually measures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .blockstore import BlockStore, StoreStats
from .external import (ExternalIndex, ExternalPlanStats, external_plan)

__all__ = ["StripedBlockStore", "ShardedExternalIndex",
           "ShardedExternalPlanStats", "sharded_external_plan"]


class StripedBlockStore(BlockStore):
    """One logical block store round-robin-striped over per-shard backends.

    ``read_rows`` splits a batch by ``row % num_shards``, serves each
    shard's sub-batch through that shard's own :class:`BlockStore` (its
    cache, its queue, its ledger), and reassembles results in request
    order; ``prefetch`` fans out the same way into each shard's cache
    arena. ``stats`` is the ROLLED-UP ledger — the field-wise sum of the
    per-shard ``StoreStats`` — so every consumer of the measured-N_io
    accounting (``external_plan``, the bench, the tie-out tests) works
    unchanged; ``per_shard_stats()`` exposes the per-drive split (the
    paper's Fig. 15 aggregate-IOPS decomposition).
    """

    def __init__(self, stores, *, nb: int, blkp: int):
        # no super().__init__(): `stats` is a rolled-up view here, not a
        # mutable field — the per-shard stores own the actual counters
        if not stores:
            raise ValueError("StripedBlockStore needs at least one shard")
        self.shards = list(stores)
        self.num_shards = len(self.shards)
        self.nb, self.blkp = int(nb), int(blkp)
        for s, st in enumerate(self.shards):
            if int(st.blkp) != self.blkp:
                raise ValueError(
                    f"shard {s} blkp {st.blkp} != striped blkp {self.blkp}")
        self.name = self.shards[0].name
        # the stripe itself never lands in the telemetry collector (it is a
        # view, not a ledger) — instead each shard store exports its own
        # series under a `shard` label, and Prometheus sums reconstruct the
        # rolled-up ledger exactly
        for s, st in enumerate(self.shards):
            getattr(st, "telemetry_labels", {})["shard"] = str(s)

    # -- rolled-up observability -------------------------------------------
    @property
    def stats(self) -> StoreStats:
        agg = StoreStats()
        for st in self.shards:
            for f in dataclasses.fields(StoreStats):
                setattr(agg, f.name,
                        getattr(agg, f.name) + getattr(st.stats, f.name))
        return agg

    def per_shard_stats(self) -> list:
        """Per-shard ledger snapshots, shard order."""
        return [st.stats.snapshot() for st in self.shards]

    @property
    def fallback_from(self) -> Optional[str]:
        """Surfaced from the shard stores (a capability fallback hits every
        shard identically — same probe, same filesystem)."""
        return getattr(self.shards[0], "fallback_from", None)

    @property
    def fallback_reason(self) -> Optional[str]:
        return getattr(self.shards[0], "fallback_reason", None)

    # -- the protocol -------------------------------------------------------
    def _split(self, rows):
        rows = np.asarray(rows, dtype=np.int64).ravel()
        return rows, rows % self.num_shards, rows // self.num_shards

    def read_rows(self, rows):
        rows, sh, loc = self._split(rows)
        ids = np.empty((rows.size, self.blkp), dtype=np.int32)
        fps = np.empty((rows.size, self.blkp), dtype=np.int32)
        for s in range(self.num_shards):
            mask = sh == s
            if not mask.any():
                continue
            i, f = self.shards[s].read_rows(loc[mask])
            ids[mask] = i
            fps[mask] = f
        return ids, fps

    def prefetch(self, rows) -> None:
        rows, sh, loc = self._split(rows)
        for s in range(self.num_shards):
            mask = sh == s
            if mask.any():
                self.shards[s].prefetch(loc[mask])

    def close(self) -> None:
        for st in self.shards:
            st.close()


@dataclasses.dataclass(eq=False)     # identity hash: telemetry WeakSet
class ShardedExternalIndex(ExternalIndex):
    """A sharded spill opened for querying: the plain :class:`ExternalIndex`
    surface (the external plan consumes it unchanged) with the block rows
    behind a :class:`StripedBlockStore` and the spill manifest attached.
    Built by ``repro_torch.storage.load_external_sharded``; served by
    ``SearchEngine(ext)`` under ``plan="sharded_external"``."""

    num_shards: int = 1
    manifest: Optional[dict] = None

    @property
    def shard_stores(self) -> list:
        return self.store.shards


@dataclasses.dataclass
class ShardedExternalPlanStats(ExternalPlanStats):
    """External-plan instrumentation plus the per-shard ledger split: the
    rolled-up ``io`` delta is the exact field-wise sum of ``per_shard`` —
    the invariant the N_io roll-up tie-out pins."""

    num_shards: int = 1
    per_shard: list = dataclasses.field(default_factory=list)  # [StoreStats]

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["num_shards"] = self.num_shards
        d["per_shard"] = [s.as_dict() for s in self.per_shard]
        return d


def sharded_external_plan(ext: ShardedExternalIndex, queries, cfg,
                          valid=None):
    """Run a query batch from the striped store. This IS ``external_plan``
    — same device programs, same host chain walk, same S-cap semantics, so
    results stay bit-exact with ``plan="fused"`` — wrapped only to snapshot
    the per-shard ledgers around the call and attach the per-drive split to
    ``ext.last_plan_stats``."""
    base = [st.stats.snapshot() for st in ext.store.shards]
    res = external_plan(ext, queries, cfg, valid)
    ps = ext.last_plan_stats
    ext.last_plan_stats = ShardedExternalPlanStats(
        backend=ps.backend, queries=ps.queries, rungs=ps.rungs, io=ps.io,
        nio_blocks_counted=ps.nio_blocks_counted, setup_ms=ps.setup_ms,
        total_ms=ps.total_ms, num_shards=ext.num_shards,
        per_shard=[st.stats.since(b)
                   for st, b in zip(ext.store.shards, base)],
    )
    return res
