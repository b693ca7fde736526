"""Synthetic ANN datasets shaped after the paper's Table 1.

Real MSONG/SIFT/GIST/... files are not available offline, so each generator
produces data with the same (d, dtype) and a difficulty knob chosen to mimic
the table's Relative Contrast ordering (GAUSS/RAND hard, SIFT/MSONG easy):
cluster count and within-cluster spread control RC — many tight clusters give
high contrast, a single isotropic blob gives RC -> 1.

`n` is scale-parameterized (the paper's n is the `full_n` field); benchmarks
run reduced n on CPU and quote full-scale numbers only via the cost model.

All datasets are rescaled so the median 1-NN distance is ~1.2: the E2LSH
radius schedule starts at R = 1 (Sec. 2.3), so coordinates must put the NN
scale near the first radius — the package's standard preprocessing step.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict

import numpy as np

__all__ = ["Dataset", "DATASETS", "make_dataset", "nn_scale"]


@dataclasses.dataclass
class Dataset:
    name: str
    db: np.ndarray        # [n, d] float32 (byte-valued data stored as float)
    queries: np.ndarray   # [Q, d] float32
    gt_ids: np.ndarray    # [Q, K] exact NN ids (K >= 100)
    gt_dists: np.ndarray  # [Q, K]
    full_n: int           # the paper's database size
    dtype_name: str       # "float" | "byte"
    scale: float          # coordinate scale applied (for reporting)


@dataclasses.dataclass(frozen=True)
class _Spec:
    d: int
    full_n: int
    dtype_name: str
    clusters: int      # 0 = no cluster structure (RAND/GAUSS)
    spread: float      # within-cluster std relative to inter-cluster distances
    uniform: bool = False


# Table 1, difficulty tuned via RC proxies (smaller RC = harder):
#   MSONG 4.04 easy | SIFT 3.20 | GIST 2.14 | RAND 1.42 | GLOVE 2.20
#   GAUSS 1.14 hardest | MNIST 3.00 | BIGANN 3.55
_SPECS: Dict[str, _Spec] = {
    "msong": _Spec(d=420, full_n=983_000, dtype_name="float", clusters=200, spread=0.10),
    "sift": _Spec(d=128, full_n=1_000_000, dtype_name="byte", clusters=150, spread=0.15),
    "gist": _Spec(d=960, full_n=1_000_000, dtype_name="float", clusters=60, spread=0.30),
    "rand": _Spec(d=100, full_n=1_000_000, dtype_name="float", clusters=0, spread=1.0, uniform=True),
    "glove": _Spec(d=100, full_n=1_183_000, dtype_name="float", clusters=80, spread=0.28),
    "gauss": _Spec(d=512, full_n=2_000_000, dtype_name="float", clusters=0, spread=1.0),
    "mnist": _Spec(d=784, full_n=8_000_000, dtype_name="byte", clusters=120, spread=0.18),
    "bigann": _Spec(d=128, full_n=1_000_000_000, dtype_name="byte", clusters=150, spread=0.14),
}


def _gen_points(spec: _Spec, n: int, rng: np.random.Generator) -> np.ndarray:
    d = spec.d
    if spec.uniform:
        x = rng.uniform(0.0, 1.0, size=(n, d))
    elif spec.clusters == 0:
        x = rng.normal(0.0, 1.0, size=(n, d))
    else:
        centers = rng.normal(0.0, 1.0, size=(spec.clusters, d))
        assign = rng.integers(0, spec.clusters, size=n)
        x = centers[assign] + spec.spread * rng.normal(size=(n, d))
    if spec.dtype_name == "byte":
        lo, hi = np.percentile(x, [1, 99])
        x = np.clip((x - lo) / max(hi - lo, 1e-9) * 255.0, 0, 255)
        x = np.round(x)
    return x.astype(np.float32)


def _exact_gt(db: np.ndarray, queries: np.ndarray, k: int):
    # NumPy blockwise exact k-NN (data sizes here are CPU-friendly)
    Q = queries.shape[0]
    n = db.shape[0]
    k = min(k, n)
    ids = np.zeros((Q, k), np.int32)
    dst = np.zeros((Q, k), np.float32)
    dbn = (db.astype(np.float64) ** 2).sum(1)
    for i in range(0, Q, 64):
        q = queries[i:i + 64].astype(np.float64)
        d2 = dbn[None, :] - 2.0 * q @ db.T.astype(np.float64) + (q * q).sum(1)[:, None]
        np.maximum(d2, 0, out=d2)
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        order = np.argsort(pd, axis=1)
        ids[i:i + 64] = np.take_along_axis(part, order, axis=1)
        dst[i:i + 64] = np.sqrt(np.take_along_axis(pd, order, axis=1))
    return ids, dst


def nn_scale(gt_dists: np.ndarray, target: float = 1.2) -> float:
    """Coordinate divisor putting the median 1-NN distance at `target`."""
    med = float(np.median(gt_dists[:, 0]))
    return max(med / target, 1e-12)


def make_dataset(name: str, *, n: int = 20_000, n_queries: int = 64,
                 gt_k: int = 100, seed: int = 0) -> Dataset:
    spec = _SPECS[name]
    # crc32, NOT hash(): str hashing is salted per process (PYTHONHASHSEED),
    # which made the "same" dataset differ between runs of the serve CLI
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    # draw db and held-out queries from the SAME distribution (one call: the
    # mixture's cluster centers must be shared)
    n_easy = (3 * n_queries) // 4
    n_hard = n_queries - n_easy
    pts = _gen_points(spec, n + n_hard, rng)
    db = pts[:n]
    q_hard = pts[n:]
    # plus perturbed database points (standard benchmark setup)
    idx = rng.choice(n, n_easy, replace=False)
    jitter = 0.35 * np.std(db, axis=0, keepdims=True)
    q_easy = db[idx] + rng.normal(size=(n_easy, spec.d)).astype(np.float32) * jitter * 0.3
    queries = np.concatenate([q_easy, q_hard], axis=0).astype(np.float32)
    gt_ids, gt_dists = _exact_gt(db, queries, gt_k)
    s = nn_scale(gt_dists)
    return Dataset(
        name=name,
        db=db / s,
        queries=queries / s,
        gt_ids=gt_ids,
        gt_dists=gt_dists / s,
        full_n=spec.full_n,
        dtype_name=spec.dtype_name,
        scale=s,
    )


DATASETS: Dict[str, Callable[..., Dataset]] = {
    name: (lambda name=name, **kw: make_dataset(name, **kw)) for name in _SPECS
}
