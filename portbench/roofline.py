"""The least time the H100 could take for a batch's work: a frozen copy of
the port's bound arithmetic (``chip_smoke.py``: ``hash_bound_ms``,
``probe_bound_ms``, ``by_id_bound_ms``), fed with work that the plain
reference counts, never with the program's counters, so the yardstick
reads the same work whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s HBM3 and 67 TFLOP/s float32
outside the tensor cores (the float32 the configuration states).
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS", "bound_ms", "hash_bound_ms",
           "probe_bound_ms", "by_id_bound_ms", "batch_least_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def bound_ms(nbytes, flops):
    """Least time for the work: bytes over HBM rate vs flops over fp32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def hash_bound_ms(n, d, r, L, m):
    """Hashing n rows under r radii: x, a, b, wR, rm read once, bucket and fp
    written once; 2*n*d*r*L*m flops."""
    rlm = r * L * m
    return bound_ms(n * d * 4 + rlm * d * 4 + 3 * rlm * 4 + 2 * n * r * L * 4,
                    2 * n * d * rlm)


def probe_bound_ms(rows_read, Q, L, BLKp, sbuf):
    """One radius's probe: the chain rows read (ids and fingerprints), the
    [Q, L] inputs and the mask in; the buffer and two counts out. Two
    compares and a select a slot."""
    return bound_ms(rows_read * 2 * BLKp * 4 + 3 * Q * L * 4 + Q + Q * sbuf * 4 + 2 * Q * 4,
                    rows_read * BLKp * 3)


def by_id_bound_ms(n_valid, Q, D, sbuf):
    """One radius's distances: a valid slot's row and norm; every slot's id in
    and distance out; the queries and their norms."""
    return bound_ms(n_valid * (D + 1) * 4 + 2 * Q * sbuf * 4 + Q * (D + 1) * 4,
                    n_valid * (2 * D + 3))


def batch_least_s(active, blocks, cands, *, d: int, L: int, m: int,
                  block_objs: int, S: int) -> float:
    """A batch's least device time, in seconds, from the reference's work per
    row and radius (``active``, ``blocks``, ``cands`` [Q, r]): each radius
    hashes, probes and measures only the rows still searching there. The
    block width is the configuration's ``block_objs`` (no padding) and the
    candidate buffer is S wide."""
    active = np.asarray(active, bool)
    blocks = np.asarray(blocks, np.int64)
    cands = np.asarray(cands, np.int64)
    total = 0.0
    for t in range(active.shape[1]):
        q = int(active[:, t].sum())
        if q == 0:
            continue
        total += hash_bound_ms(q, d, 1, L, m)[0]
        total += probe_bound_ms(int(blocks[:, t].sum()), q, L, block_objs, S)[0]
        total += by_id_bound_ms(int(cands[:, t].sum()), q, d, S)[0]
    return total * 1e-3
