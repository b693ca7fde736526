"""SRS baseline (Sun et al., VLDB 2014): a tiny index for c-ANN search, an
m-dimensional Gaussian projection with incremental candidate checking
(counterpart of ``repro.baselines.srs``).

The original walks an R-tree over the projected points for incremental NN
retrieval. Like the reference, the port scans every projected distance and
orders them instead: the same O(n) work, and favourable to SRS in speed
comparisons, since an R-tree adds per-node overhead. Its semantics stay:

  * candidates are visited in increasing projected distance (ties: the
    lower id first);
  * the search stops early when the next candidate's projected distance
    passes the chi-squared quantile bound on the best true distance so far;
  * it stops after T' checked candidates (the accuracy knob, Sec. 3.3).

The T' true distances are computed by the query plans' distance epilogue,
``kernels.l2_distance.l2_distance_by_id`` (``csrc/l2_distance.cu`` on a CUDA
tensor, its plain version on a CPU one), whose formula
``max(||x||^2 - 2 <x, q> + ||q||^2, 0)`` is the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from ..kernels.l2_distance.ops import l2_distance_by_id

__all__ = ["SRSIndex", "build_srs", "srs_query"]

_PD2_CHUNK_BYTES = 1 << 28   # the [Q, rows, m] difference block of one pd2 step


@dataclasses.dataclass
class SRSIndex:
    proj: torch.Tensor       # [d, m] Gaussian projection
    proj_db: torch.Tensor    # [n, m]
    db: torch.Tensor         # [n, d]
    db_norm2: torch.Tensor   # [n]
    m: int

    @property
    def index_bytes(self) -> int:
        """The "tiny index": the projected coordinates only (paper Table 6)."""
        return int(self.proj_db.numel() * 4)

    @property
    def device(self) -> torch.device:
        return self.db.device

    @staticmethod
    def from_numpy(*, proj, db, device=None) -> "SRSIndex":
        """An index over ``db`` with a given projection (tests carry the
        reference's ``proj`` across, which a torch generator cannot draw)."""
        dev = resolve_device(device)
        proj = torch.from_numpy(np.array(proj, np.float32, order="C")).to(dev)
        return _index(proj, db, dev)


def _index(proj: torch.Tensor, db, dev: torch.device) -> SRSIndex:
    db_np = np.ascontiguousarray(db.cpu().numpy() if torch.is_tensor(db) else db,
                                 dtype=np.float32)
    x = torch.from_numpy(db_np).to(dev)
    return SRSIndex(proj=proj, proj_db=x @ proj, db=x,
                    db_norm2=(x * x).sum(dim=-1), m=int(proj.shape[1]))


def build_srs(db, *, m: int = 8, seed: int = 0, device=None) -> SRSIndex:
    """Project ``db`` [n, d] onto m Gaussian directions scaled by
    1/sqrt(m), drawn from a CPU generator seeded with ``seed``, on
    ``device`` (None -> cuda)."""
    dev = resolve_device(device)
    d = int(db.shape[1])
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn((d, m), generator=gen, dtype=torch.float32) / math.sqrt(m)
    return _index(proj.to(dev), db, dev)


def _chi2_quantile(m: int, p: float) -> float:
    """Wilson-Hilferty approximation of the chi-squared quantile."""
    z = _norm_ppf(p)
    return m * (1.0 - 2.0 / (9.0 * m) + z * math.sqrt(2.0 / (9.0 * m))) ** 3


def _norm_ppf(p: float) -> float:
    # Beasley-Springer-Moro
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def _projected_d2(proj_db: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """pd2 [Q, n]: squared projected distances by direct differences over m,
    as the reference forms them, in row chunks that bound the [Q, rows, m]
    difference block."""
    Q, m = qp.shape
    n = proj_db.shape[0]
    pd2 = torch.empty((Q, n), dtype=torch.float32, device=qp.device)
    rows = max(1, _PD2_CHUNK_BYTES // max(1, Q * m * 4))
    for s in range(0, n, rows):
        pd2[:, s:s + rows] = ((proj_db[None, s:s + rows] - qp[:, None]) ** 2).sum(-1)
    return pd2


def _smallest_lower_id_first(pd2: torch.Tensor, t: int):
    """The t smallest entries of each row in ascending order, equal values
    by ascending index: ``jax.lax.top_k(-pd2, t)``'s selection and order,
    which ``torch.topk`` does not promise. Returns (values, index [Q, t]
    int64). A row whose t-th value also occurs outside the top-t (a tie
    across the cut) is re-selected from its full row."""
    vals, idx = torch.topk(pd2, t, dim=1, largest=False, sorted=True)
    last = vals[:, -1:]
    cut_ties = (pd2 == last).sum(dim=1) != (vals == last).sum(dim=1)
    for row in torch.nonzero(cut_ties).flatten().tolist():
        order = torch.sort(pd2[row], stable=True).indices[:t]
        idx[row], vals[row] = order, pd2[row, order]
    # lower index first among equal values inside the selection
    idx = torch.sort(idx, dim=1).values
    vals = torch.gather(pd2, 1, idx)
    vals, pos = torch.sort(vals, dim=1, stable=True)
    return vals, torch.gather(idx, 1, pos)


def srs_query(index: SRSIndex, queries, *, k: int = 1, t_prime: int = 512,
              p_tau: float = 0.9):
    """``p_tau``: the early-termination confidence (the chi-squared test on
    m degrees of freedom). Returns (ids [Q, k] int32, dists [Q, k] float32,
    checked [Q] int32) on the index's device."""
    dev = index.device
    if not torch.is_tensor(queries):
        queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
    q = queries.to(dev, torch.float32).contiguous()
    Q = q.shape[0]
    t_prime = int(min(t_prime, index.db.shape[0]))
    stop_mult = torch.tensor(_chi2_quantile(index.m, p_tau) / index.m,
                             dtype=torch.float32, device=dev)
    qp = q @ index.proj                                       # [Q, m]
    pd2 = _projected_d2(index.proj_db, qp)
    pd2_sorted, order = _smallest_lower_id_first(pd2, t_prime)  # [Q, T']
    del pd2
    qn2 = (q * q).sum(dim=-1)
    d2 = l2_distance_by_id(q, order.to(torch.int32), index.db, index.db_norm2, qn2)
    # candidate i is examined unless the best true distance among the earlier
    # candidates already certified the stop test against its projected one
    best_before = torch.cat([torch.full((Q, 1), torch.inf, device=dev),
                             torch.cummin(d2, dim=1).values[:, :-1]], dim=1)
    stop = pd2_sorted > stop_mult * best_before
    examined = (torch.cumsum(stop, dim=1) == 0)
    examined[:, 0] = True
    d2 = torch.where(examined, d2, torch.inf)
    top = torch.sort(d2, dim=1, stable=True)
    ids = torch.gather(order, 1, top.indices[:, :k]).to(torch.int32)
    return ids, torch.sqrt(top.values[:, :k]), examined.sum(dim=1, dtype=torch.int32)
