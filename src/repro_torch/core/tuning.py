"""Accuracy metric of the paper (Sec. 3.2): the overall ratio,
(1/k) * sum_i ||o_i, q|| / ||o_i*, q||; 1.0 = exact."""
from __future__ import annotations

import numpy as np

__all__ = ["overall_ratio"]


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
