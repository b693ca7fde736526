"""Brute-force exact k-NN (ground truth for overall-ratio evaluation).

The scan walks the database in blocks of ``block`` rows. Each block's
[Q, block] squared distances come from the dense ``l2_distance`` kernel
(``csrc/l2_distance_dense.cu`` on a CUDA tensor, its plain version on a CPU
one), and the running top-k merges with them as in the reference: the
concatenation of the best k so far and the block, a stable sort, the first
k. Ties therefore resolve to the lower id, as there.

The reference forms each block as ``xn2 - 2 q.x^T + qn2`` with the norms
computed outside; the kernel computes ``(qn2 + xn2) - 2 dot`` with the norms
summed inside it, so the two agree to rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..kernels.l2_distance.ops import l2_distance

__all__ = ["exact_knn", "exact_knn_np"]


def _as_f32(x, dev: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(dev, torch.float32).contiguous()


def exact_knn(db, queries, k: int = 1, block: int = 16384, device=None):
    """Returns (ids [Q, k] int32, dists [Q, k] float32) of the exact nearest
    neighbours, on ``device`` (None -> cuda). The last block is passed at its
    true width (the kernel bounds-checks ragged shapes), so there are no
    padding rows past n for the reference's index mask to hide."""
    dev = resolve_device(device)
    db = _as_f32(db, dev)
    q = _as_f32(queries, dev)
    n, Q = db.shape[0], q.shape[0]
    block = min(block, max(128, n))
    best_d = torch.full((Q, k), torch.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    for start in range(0, n, block):
        x = db[start:start + block]
        d2 = l2_distance(q, x)                                     # [Q, nb]
        idx = torch.arange(start, start + x.shape[0], dtype=torch.int32, device=dev)
        cat_d = torch.cat([best_d, d2], dim=1)
        cat_i = torch.cat([best_i, idx.expand(Q, -1)], dim=1)
        cat_d, order = torch.sort(cat_d, dim=1, stable=True)
        best_d = cat_d[:, :k].contiguous()
        best_i = torch.gather(cat_i, 1, order[:, :k])
    return best_i, torch.sqrt(best_d)


def exact_knn_np(db: np.ndarray, queries: np.ndarray, k: int = 1):
    """NumPy float64 oracle (tests)."""
    db = np.asarray(db, dtype=np.float64)
    q = np.asarray(queries, dtype=np.float64)
    d2 = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :k]
    return idx.astype(np.int32), np.sqrt(np.take_along_axis(d2, idx, axis=1)).astype(np.float32)
