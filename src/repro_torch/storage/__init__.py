"""The storage tier of the port: E2LSH on Storage, run from a spill file.

* ``format``     — the versioned, page-aligned on-disk spill format, byte
  for byte the reference's (``IndexArrays.spill`` / ``load_external``);
* ``blockstore`` — pluggable block-read backends
  (``mem``/``mmap``/``aio``/``uring``) with the measured-N_io ledger and
  the shared clock page cache (``REPRO_STORE_BACKEND`` forces a backend);
* ``uring``      — io_uring wave submission + O_DIRECT aligned reads via
  ctypes, with the runtime ``capabilities()`` probe that gates it;
* ``external``   — ``plan="external"``: hash and table lookups on the
  device, block fetches on the host, the distance fold back on the device,
  with per-rung overlap stats;
* ``sharded``    — ``plan="sharded_external"``: the same plan over block
  rows striped across per-shard files;
* ``measure``    — the measured sync-vs-async harness (cold-cache
  methodology and the queue-depth sweep).
"""
from .blockstore import (AioBlockStore, BACKENDS, BlockStore,
                         CachedBlockStore, MemBlockStore, MmapBlockStore,
                         STORE_BACKEND_ENV, StoreStats, make_store,
                         store_backend_env)
from .external import (ExternalIndex, ExternalPlanStats, ExternalPlanTotals,
                       RungStats, external_plan)
from .format import (DIRECT_ALIGN_MIN, FORMAT_VERSION, MAGIC,
                     MANIFEST_MAGIC, MANIFEST_NAME, MANIFEST_VERSION,
                     PAGE_SIZE, SpillHeader, StorageFormatError,
                     aligned_extent, load_arrays, load_arrays_sharded,
                     load_external, load_external_sharded, read_header,
                     read_manifest, spill_index, spill_index_sharded,
                     verify_file)
from .sharded import (ShardedExternalIndex, ShardedExternalPlanStats,
                      StripedBlockStore, sharded_external_plan)
from .measure import (DEFAULT_MODEL_CONFIG, HEAVY_SPEC, SWEEP_QDS,
                      drop_page_cache, heavy_bucket_workload,
                      measure_backends, page_cache_residency, qd_sweep)
from .uring import (IoUring, UringBlockStore, UringUnavailable,
                    capabilities, probe_io_uring, probe_o_direct)

__all__ = [
    "AioBlockStore", "BACKENDS", "BlockStore", "CachedBlockStore",
    "MemBlockStore", "MmapBlockStore", "STORE_BACKEND_ENV", "StoreStats",
    "make_store", "store_backend_env",
    "ExternalIndex", "ExternalPlanStats", "ExternalPlanTotals", "RungStats",
    "external_plan",
    "ShardedExternalIndex", "ShardedExternalPlanStats", "StripedBlockStore",
    "sharded_external_plan",
    "DIRECT_ALIGN_MIN", "FORMAT_VERSION", "MAGIC", "MANIFEST_MAGIC",
    "MANIFEST_NAME", "MANIFEST_VERSION", "PAGE_SIZE",
    "SpillHeader", "StorageFormatError", "aligned_extent", "load_arrays",
    "load_arrays_sharded", "load_external", "load_external_sharded",
    "read_header", "read_manifest", "spill_index", "spill_index_sharded",
    "verify_file",
    "DEFAULT_MODEL_CONFIG", "HEAVY_SPEC", "SWEEP_QDS", "drop_page_cache",
    "heavy_bucket_workload", "measure_backends", "page_cache_residency",
    "qd_sweep",
    "IoUring", "UringBlockStore", "UringUnavailable", "capabilities",
    "probe_io_uring", "probe_o_direct",
]
