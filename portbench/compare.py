"""The comparison that decides ``correct``: the program's answers against
the plain reference's, row by row.

Two numbers come out of it:

* ``rows_off``: the share of rows the reference could decide whose result
  differs from the reference's in any field: ``found``, ``radii_searched``,
  ``nio_table``, ``nio_blocks`` (the chain blocks read), ``cands_checked``,
  or the top-k ids (two ids may trade places only where their exact
  distances tie within ``TIE_TOL``; a row may not name one id twice). The
  hash stage shows through all of them: a wrong bucket or fingerprint
  changes the blocks read and the candidates found.
* ``dist_err``: over every answer of every row, the largest gap between the
  distance the program reports for an id and that id's exact float64
  distance, as a share of (|x| + |q|)^2 in squared distance (the scale of
  float32 rounding in |x|^2 - 2 x.q + |q|^2). An id outside the database, or
  a distance where the id is missing, or none where it is given, reads inf.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import INVALID, RefResult, Reference

__all__ = ["Answers", "TIE_TOL", "judge"]

TIE_TOL = 2e-6   # of (|x| + |q|)^2, in squared distance
_INT_FIELDS = ("found", "radii_searched", "nio_table", "nio_blocks", "cands_checked")


@dataclasses.dataclass
class Answers:
    """The program's result fields for a set of rows, on the host."""

    ids: np.ndarray             # [R, k]
    dists: np.ndarray           # [R, k]
    found: np.ndarray           # [R]
    radii_searched: np.ndarray
    nio_table: np.ndarray
    nio_blocks: np.ndarray
    cands_checked: np.ndarray

    @staticmethod
    def of(result) -> "Answers":
        """From any object with the result's fields (a ``QueryResult``)."""
        return Answers(**{f.name: np.asarray(getattr(result, f.name).cpu().numpy())
                          for f in dataclasses.fields(Answers)})

    @staticmethod
    def concat(parts) -> "Answers":
        return Answers(**{f.name: np.concatenate([getattr(p, f.name) for p in parts])
                          for f in dataclasses.fields(Answers)})


def judge(prog: Answers, ref: RefResult, queries: torch.Tensor,
          reference: Reference) -> dict:
    """Readings over the rows of ``queries`` (ref and prog row-aligned)."""
    ref = ref.cpu()
    q = queries.to(reference.dev)
    k = ref.ids.shape[1]
    if prog.ids.shape != (q.shape[0], k):
        return dict(rows_off=1.0, dist_err=float("inf"), rows=int(q.shape[0]),
                    ambiguous=0, shape_error=f"ids {prog.ids.shape}, want {(q.shape[0], k)}")
    pid = torch.from_numpy(prog.ids.astype(np.int64)).to(reference.dev)
    pd = torch.from_numpy(prog.dists.astype(np.float64)).to(reference.dev)
    valid = pid != INVALID
    d2p = reference.exact_d2(q, pid)
    qn = torch.sqrt((q.to(torch.float64) ** 2).sum(1))[:, None]
    safe = torch.where((pid >= 0) & (pid < reference.db.shape[0]), pid, 0)
    scale = (reference.db_norm[safe] + qn) ** 2
    err = (pd * pd - d2p).abs() / scale
    bad = (valid & (torch.isnan(d2p) | torch.isinf(pd))) | (~valid & ~torch.isinf(pd))
    err = torch.where(bad, torch.inf, torch.where(valid, err, 0.0))
    dist_err = float(err.max()) if err.numel() else 0.0

    rid = ref.ids.to(reference.dev)
    rvalid = rid != INVALID
    rscale = (reference.db_norm[torch.where(rvalid, rid, 0)] + qn) ** 2
    tie = TIE_TOL * torch.maximum(scale, rscale)
    same = (pid == rid) | ((d2p - ref.d2.to(reference.dev)).abs() <= tie)
    slot_ok = (valid == rvalid) & (~valid | same)
    srt = torch.sort(torch.where(valid, pid, -1 - torch.arange(k, device=pid.device)), 1).values
    no_dup = (srt[:, 1:] != srt[:, :-1]).all(1)
    row_ok = slot_ok.all(1) & no_dup
    for name in _INT_FIELDS:
        mine = torch.from_numpy(np.asarray(getattr(prog, name)).astype(np.int64))
        row_ok &= (mine == getattr(ref, name).to(torch.int64)).to(reference.dev)
    decided = ~ref.ambiguous.to(reference.dev)
    n_dec = int(decided.sum())
    rows_off = float((~row_ok & decided).sum()) / max(1, n_dec)
    return dict(rows_off=rows_off, dist_err=dist_err, rows=int(q.shape[0]),
                ambiguous=int(q.shape[0] - n_dec))
