"""QALSH baseline (Huang et al., VLDB 2015): query-aware LSH with collision
counting and virtual rehashing (counterpart of ``repro.baselines.qalsh``).

Index: K 1-D Gaussian projections; per line the database projections are
kept sorted (the paper's B+-trees; a sorted tensor and ``searchsorted`` give
the same O(log n) lookup and window expansion).

Query: each line's window is anchored at the query's projection
(query-aware). For rounds R = 1, c, c^2, ... the window widens to w*R/2 on
each side, each object's collisions over the lines are counted, and the
objects whose count reaches the threshold l are distance-checked. A query
stops when k objects lie within c*R (E2LSH's (R, c)-NN outer loop) or the
candidate budget is spent.

The reference counts in numpy, line by line. Here one query's rounds run
on the index's device: the windows of every line and round come from two
``searchsorted`` calls and one host transfer (the query's projections are
formed on the host, so both devices place the windows alike), and a round
is a handful of
launches over all K lines at once (the newly covered id ranges flattened by
a ``repeat_interleave`` ramp, the counts bumped by ``index_add_``, the
candidates taken by ``nonzero``, the one wait of the round). The outer loop
over queries and rounds, and the stop test, are the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

__all__ = ["QALSHIndex", "default_k", "build_qalsh", "qalsh_query"]


@dataclasses.dataclass
class QALSHIndex:
    proj: torch.Tensor          # [d, K]
    sorted_vals: torch.Tensor   # [K, n] sorted projections
    sorted_ids: torch.Tensor    # [K, n] int32
    db: torch.Tensor            # [n, d]
    w: float
    K: int
    collision_ratio: float      # l / K threshold (paper: alpha)

    @property
    def index_bytes(self) -> int:
        return int(self.sorted_vals.nbytes + self.sorted_ids.nbytes)

    @property
    def device(self) -> torch.device:
        return self.db.device

    @staticmethod
    def from_numpy(*, proj, sorted_vals, sorted_ids, db, w: float,
                   collision_ratio: float, device=None) -> "QALSHIndex":
        """Carry an index across (tests: the reference's leaves, whose
        argsort may order equal projections otherwise)."""
        dev = resolve_device(device)

        def t(x, dtype):
            return torch.from_numpy(np.array(x, dtype, order="C")).to(dev)

        proj = t(proj, np.float32)
        return QALSHIndex(proj=proj, sorted_vals=t(sorted_vals, np.float32),
                          sorted_ids=t(sorted_ids, np.int32), db=t(db, np.float32),
                          w=float(w), K=int(proj.shape[1]),
                          collision_ratio=float(collision_ratio))


def default_k(n: int, *, delta: float = 1.0 / math.e, w: float = 2.0,
              c: float = 2.0) -> int:
    """The paper's K: enough lines that collision counting separates near
    from far with success probability 1 - delta (constants simplified)."""
    return max(32, int(math.ceil(2.0 * math.log(n))) * 8)


def build_qalsh(db, *, K: Optional[int] = None, w: float = 2.0,
                collision_ratio: float = 0.45, seed: int = 0,
                device=None) -> QALSHIndex:
    """Project ``db`` [n, d] onto K Gaussian lines, drawn as the reference
    draws them (``np.random.default_rng(seed)``), and sort each line on
    ``device`` (None -> cuda)."""
    dev = resolve_device(device)
    db_np = np.ascontiguousarray(db.cpu().numpy() if torch.is_tensor(db) else db,
                                 dtype=np.float32)
    n, d = db_np.shape
    K = K or default_k(n)
    proj = np.random.default_rng(seed).normal(size=(d, K)).astype(np.float32)
    x = torch.from_numpy(db_np).to(dev)
    p = torch.from_numpy(proj).to(dev)
    sorted_vals, order = torch.sort((x @ p).T.contiguous(), dim=1, stable=True)
    return QALSHIndex(proj=p, sorted_vals=sorted_vals,
                      sorted_ids=order.to(torch.int32), db=x, w=float(w), K=int(K),
                      collision_ratio=float(collision_ratio))


def _ramp(starts: torch.Tensor, lens: torch.Tensor, total: int) -> torch.Tensor:
    """Concatenated ranges [starts[i], starts[i] + lens[i]) as one int64
    tensor of ``total`` (= lens.sum(), known on the host, so no wait)
    positions."""
    ends = torch.cumsum(lens, 0)
    return (torch.arange(total, dtype=torch.int64, device=starts.device)
            + torch.repeat_interleave(starts - (ends - lens), lens, output_size=total))


def qalsh_query(index: QALSHIndex, queries, *, k: int = 1, c: float = 2.0,
                max_rounds: int = 12, budget_frac: float = 0.05):
    """Returns (ids [Q, k] int32, dists [Q, k] float32, checked [Q] int64,
    rounds [Q] int32) on the index's device."""
    dev = index.device
    db = index.db
    n = db.shape[0]
    K = index.K
    l_thresh = max(2, int(round(index.collision_ratio * K)))
    budget = max(k + 20, int(budget_frac * n))
    keep = max(k, 16)
    if not torch.is_tensor(queries):
        queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    queries = queries.to(dev, torch.float32)
    Q = queries.shape[0]
    out_ids = torch.full((Q, k), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((Q, k), torch.inf, dtype=torch.float32, device=dev)
    out_checked = np.zeros((Q,), np.int64)
    out_rounds = np.zeros((Q,), np.int32)

    sv, sid = index.sorted_vals, index.sorted_ids.reshape(-1)
    lines = (torch.arange(K, dtype=torch.int64, device=dev) * n).repeat(2)
    radii = [1.0]
    for _ in range(max_rounds - 1):
        radii.append(radii[-1] * c)
    halves = torch.tensor([index.w * R / 2.0 for R in radii], dtype=torch.float32,
                          device=dev)
    # the projections that place the windows are formed on the host in
    # float32, as the reference's numpy forms them: a window's edges then do
    # not depend on the device's summation order
    qproj_all = (queries.cpu() @ index.proj.cpu()).to(dev)    # [Q, K]
    for qi in range(Q):
        qp = qproj_all[qi]
        # every round's window on every line: the anchor (side left), the low
        # edges (left) and the high edges (right); the host keeps a copy for
        # the sizes of the ranges each round adds
        left = torch.searchsorted(sv, torch.cat([qp[:, None], qp[:, None] - halves[None]],
                                                dim=1).contiguous())
        right = torch.searchsorted(sv, (qp[:, None] + halves[None]).contiguous(),
                                   right=True)
        edges = torch.cat([left, right], dim=1)            # [K, 1 + 2 * rounds]
        edges_h = edges.cpu()
        lo, hi = edges[:, 0], edges[:, 0]
        lo_h, hi_h = edges_h[:, 0], edges_h[:, 0]
        counts = torch.zeros((n,), dtype=torch.int32, device=dev)
        checked = torch.zeros((n,), dtype=torch.bool, device=dev)
        best_d = torch.empty((0,), dtype=torch.float32, device=dev)
        best_i = torch.empty((0,), dtype=torch.int64, device=dev)
        n_checked = 0
        pending = None   # the last round's number and its count within c*R
        for rnd in range(max_rounds + 1):
            if rnd < max_rounds:
                # the newly covered sorted positions of every line, both sides
                new_lo = torch.minimum(edges[:, 1 + rnd], lo)
                new_hi = torch.maximum(edges[:, 1 + max_rounds + rnd], hi)
                new_lo_h = torch.minimum(edges_h[:, 1 + rnd], lo_h)
                new_hi_h = torch.maximum(edges_h[:, 1 + max_rounds + rnd], hi_h)
                total = int((lo_h - new_lo_h).sum() + (new_hi_h - hi_h).sum())
                if total:
                    pos = _ramp(torch.cat([new_lo, hi]) + lines,
                                torch.cat([lo - new_lo, new_hi - hi]), total)
                    counts.index_add_(0, sid[pos].to(torch.int64),
                                      torch.ones((total,), dtype=torch.int32, device=dev))
                lo, hi, lo_h, hi_h = new_lo, new_hi, new_lo_h, new_hi_h
                # the round's one wait; the last round's stop test reads a
                # count already computed behind it
                cand = torch.nonzero((counts >= l_thresh) & ~checked).flatten()
            if pending is not None:
                last, within = pending
                if int(within) >= k or n_checked >= budget:
                    out_rounds[qi] = last + 1
                    break
            if rnd == max_rounds:
                out_rounds[qi] = max_rounds
                break
            if cand.numel():
                checked[cand] = True
                n_checked += cand.numel()
                d = torch.sqrt(torch.clamp(((db[cand] - queries[qi][None]) ** 2).sum(1),
                                           min=0.0))
                # the reference's list of (dist, id), sorted, cut to max(k, 16)
                all_d, all_i = torch.cat([best_d, d]), torch.cat([best_i, cand])
                by_id = torch.sort(all_i).indices
                by_d = torch.sort(all_d[by_id], stable=True).indices[:keep]
                best_i, best_d = all_i[by_id][by_d], all_d[by_id][by_d]
            pending = (rnd, (best_d.double() <= c * radii[rnd]).sum())
        out_checked[qi] = n_checked
        m = min(k, best_d.numel())
        out_ids[qi, :m] = best_i[:m].to(torch.int32)
        out_d[qi, :m] = best_d[:m]
    return (out_ids, out_d, torch.from_numpy(out_checked).to(dev),
            torch.from_numpy(out_rounds).to(dev))
