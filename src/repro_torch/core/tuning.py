"""Accuracy tuning (paper Sec. 3.3): hit a target overall ratio by scaling
gamma (hash length m) and the candidate cap S, without changing L.

overall ratio (Sec. 3.2): (1/k) * sum_i ||o_i, q|| / ||o_i*, q||; 1.0 = exact.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .e2lshos import E2LSHoS

__all__ = ["overall_ratio", "tune_gamma", "TuneResult"]


def overall_ratio(dists: np.ndarray, exact_dists: np.ndarray) -> float:
    """Mean over queries of mean_i(d_i / d*_i). Unfound (inf) entries are
    scored against the worst observed ratio, penalizing failures."""
    d = np.asarray(dists, dtype=np.float64)
    g = np.maximum(np.asarray(exact_dists, dtype=np.float64), 1e-30)
    ratio = d / g
    finite = np.isfinite(ratio)
    if not finite.any():
        return float("inf")
    worst = ratio[finite].max()
    ratio = np.where(finite, ratio, max(worst, 10.0))
    # exact zero-distance matches give d == g == 0 -> ratio 1
    ratio = np.where((d == 0) & (np.asarray(exact_dists) == 0), 1.0, ratio)
    return float(ratio.mean(axis=1).mean())


@dataclasses.dataclass
class TuneResult:
    gamma: float
    s_scale: float
    ratio: float
    index: E2LSHoS


def tune_gamma(db, queries, exact_dists: np.ndarray, *,
               target_ratio: float = 1.05, k: int = 1, c: float = 2.0,
               w: float = 4.0, gammas=(0.5, 0.7, 0.9, 1.1),
               s_scales=(1.0, 2.0, 4.0), seed: int = 0, max_L: int = 64,
               device=None) -> TuneResult:
    """Grid-walk gamma (coarse accuracy knob; smaller m -> more collisions ->
    higher recall and more candidates), then s_scale (fine knob), building
    each index on ``device`` (None -> cuda), until the target overall ratio
    is met. Returns the first passing configuration, or the best one seen."""
    best: Optional[TuneResult] = None
    for gamma in gammas:
        for s_scale in s_scales:
            idx = E2LSHoS.build(db, c=c, w=w, gamma=gamma, s_scale=s_scale,
                                seed=seed, max_L=max_L, device=device)
            res = idx.query(queries, k=k)
            ratio = overall_ratio(res.dists.cpu().numpy(), exact_dists)
            cand = TuneResult(gamma=gamma, s_scale=s_scale, ratio=ratio, index=idx)
            if best is None or ratio < best.ratio:
                best = cand
            if ratio <= target_ratio:
                return cand
    assert best is not None
    return best
