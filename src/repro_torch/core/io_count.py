"""N_io accounting and block-size analysis (paper Sec. 4.3, Figs. 3-8).

Two estimators, both fed by measured query statistics:

* `nio_infinity` — the conservative estimate N_io,inf of Table 4: every bucket
  fits one block, so each non-empty probed bucket costs 2 I/Os (hash-table
  read + one bucket read). Empty buckets cost nothing (DRAM bitmap).

* `nio_for_block_size` — the practical estimate of Fig. 3: replays the
  recorded probe trace (bucket sizes per query x radius) under an arbitrary
  block size B, honoring the S candidate cap which truncates chains
  mid-bucket. Entry/header byte constants follow Sec. 5.1 (5 B object info,
  16 B header).
"""
from __future__ import annotations

import numpy as np

from .probabilities import BLOCK_HEADER_BYTES, OBJECT_INFO_BYTES

__all__ = ["nio_infinity", "nio_for_block_size", "replay_probe_trace"]


def nio_infinity(probe_sizes: np.ndarray) -> np.ndarray:
    """N_io,inf per query from a probe trace [Q, r, L] (-1 = not probed /
    empty). 2 I/Os per non-empty probed bucket (table + single block)."""
    probed = np.asarray(probe_sizes) > 0
    return 2 * probed.sum(axis=(1, 2))


def _objs_per_block(block_bytes: int) -> int:
    return max(1, (block_bytes - BLOCK_HEADER_BYTES) // OBJECT_INFO_BYTES)


def replay_probe_trace(sizes: np.ndarray, s_cap: int, block_bytes: int,
                       order: str = "roundrobin") -> tuple:
    """Replay one query-radius probe: `sizes` = bucket sizes (<=0 -> skip),
    read in block-size chunks with an S candidate budget.

    order="roundrobin" matches the batched runtime walker (chunk j of every
    still-active bucket per step). order="sequential" matches the paper's
    single-query loop (bucket after bucket, chunk after chunk, stop at S —
    used for the Fig. 3/4 block-size analysis). Returns
    (table_reads, block_reads).
    """
    sizes = np.asarray(sizes)
    sizes = sizes[sizes > 0]
    if sizes.size == 0:
        return 0, 0
    blk = _objs_per_block(block_bytes)
    block_reads = 0
    collected = 0
    if order == "sequential":
        table_reads = 0
        for size in sizes:
            if collected >= s_cap:
                break  # search stopped: later buckets are never touched
            table_reads += 1
            taken = 0
            while taken < size and collected < s_cap:
                take = min(blk, int(size) - taken)
                block_reads += 1
                taken += take
                collected += take
        return table_reads, block_reads
    table_reads = int(sizes.size)
    step = 0
    max_steps = int(np.ceil(sizes.max() / blk))
    while collected < s_cap and step < max_steps:
        active = sizes > step * blk
        n_active = int(active.sum())
        if n_active == 0:
            break
        block_reads += n_active
        got = np.minimum(sizes[active] - step * blk, blk).sum()
        collected += int(got)
        step += 1
    return table_reads, block_reads


def nio_for_block_size(probe_sizes: np.ndarray, s_cap: int, block_bytes: int,
                       order: str = "roundrobin") -> np.ndarray:
    """N_io per query for a finite block size B (Fig. 3). probe_sizes:
    [Q, r, L] with -1 for unprobed; budget S applies per radius."""
    probe_sizes = np.asarray(probe_sizes)
    Q, r, L = probe_sizes.shape
    out = np.zeros((Q,), dtype=np.int64)
    for q in range(Q):
        total = 0
        for t in range(r):
            tr, br = replay_probe_trace(probe_sizes[q, t], s_cap, block_bytes,
                                        order=order)
            total += tr + br
        out[q] = total
    return out
