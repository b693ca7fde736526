"""Shape-matched ANN data made on the device from the run's seed.

A frozen rewrite of the port's ``data/synthetic.py`` ``"sift"`` spec: a
mixture of ``clusters`` Gaussian blobs (centres N(0, I), within-cluster
std ``spread``), quantised to byte values through the 1st..99th percentile
range, then divided by one scale that puts the median nearest-neighbour
distance of the queries at ``nn_target`` (the E2LSH radius schedule starts
at R = 1). Queries are ``easy_share`` perturbed database points (Gaussian
jitter of ``jitter`` times each coordinate's std) and the rest held-out
points of the same mixture; row i of the pool is held out iff
``i % 4 == 3`` at the default 3/4 share, so every batch carries the mix.

Everything is drawn with one ``torch.Generator`` on ``device`` in a fixed
order of a few large calls, so the same seed gives the same data on the
same kind of device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DataSpec", "Dataset", "make_dataset", "held_out_mask", "GENERATORS"]

GENERATORS = ("sift",)       # the names a configuration's ``data.generator`` may give

_QUANTILE_SAMPLE = 1 << 22   # coordinates the byte range is read from
_SCALE_QUERIES = 1024        # queries whose 1-NN distances set the scale
_DB_BLOCK = 1 << 17          # database rows per exact-distance block


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """The generator's parameters, as a configuration file states them."""

    n: int
    d: int
    clusters: int
    spread: float
    easy_share: float = 0.75
    jitter: float = 0.105
    nn_target: float = 1.2

    @staticmethod
    def from_config(cfg: dict) -> "DataSpec":
        """The configuration's ``data``; its ``generator`` must be one this
        module makes."""
        data = cfg["data"]
        if data.get("generator") not in GENERATORS:
            raise ValueError(f"unknown data generator {data.get('generator')!r}; "
                             f"portbench/data.py makes {list(GENERATORS)}")
        return DataSpec(n=int(cfg["n"]), d=int(cfg["d"]),
                        clusters=int(data["clusters"]), spread=float(data["spread"]),
                        easy_share=float(data["easy_share"]),
                        jitter=float(data["jitter"]), nn_target=float(data["nn_target"]))


@dataclasses.dataclass
class Dataset:
    db: torch.Tensor        # [n, d] float32 on the device
    queries: torch.Tensor   # [Q, d] float32 on the device
    scale: float            # the divisor applied to the byte values


def held_out_mask(count: int, easy_share: float) -> torch.Tensor:
    """Which pool rows are held-out points: an even spread, ``1 - easy_share``
    of every stretch (i % 4 == 3 at 3/4)."""
    i = torch.arange(count, dtype=torch.float64)
    hard_share = 1.0 - easy_share
    return torch.floor((i + 1) * hard_share) > torch.floor(i * hard_share)


def _quantise_bytes(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    step = max(1, flat.numel() // _QUANTILE_SAMPLE)
    sample = torch.sort(flat[::step]).values
    lo = sample[int(0.01 * (sample.numel() - 1))]
    hi = sample[int(0.99 * (sample.numel() - 1))]
    x = (x - lo) / torch.clamp(hi - lo, min=1e-9) * 255.0
    return torch.round(torch.clamp(x, 0.0, 255.0))


def _median_nn_distance(db: torch.Tensor, queries: torch.Tensor) -> float:
    """Median over the queries of the exact 1-NN distance, in float64."""
    q = queries.to(torch.float64)
    qn = (q * q).sum(1)
    best = torch.full((q.shape[0],), float("inf"), dtype=torch.float64, device=q.device)
    for s in range(0, db.shape[0], _DB_BLOCK):
        x = db[s:s + _DB_BLOCK].to(torch.float64)
        d2 = qn[:, None] + (x * x).sum(1)[None] - 2.0 * (q @ x.T)
        best = torch.minimum(best, d2.amin(dim=1))
    return float(torch.sqrt(torch.clamp(best, min=0.0)).median())


def make_dataset(spec: DataSpec, n_queries: int, seed: int, device) -> Dataset:
    """The database and a pool of ``n_queries`` queries from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    hard = held_out_mask(n_queries, spec.easy_share).to(dev)
    n_hard = int(hard.sum())
    n_easy = n_queries - n_hard
    rows = spec.n + n_hard
    centers = torch.randn((spec.clusters, spec.d), generator=g, device=dev)
    assign = torch.randint(0, spec.clusters, (rows,), generator=g, device=dev)
    pts = centers[assign]
    pts += spec.spread * torch.randn((rows, spec.d), generator=g, device=dev)
    del assign
    pts = _quantise_bytes(pts)
    db = pts[:spec.n]
    q_hard = pts[spec.n:]
    # perturbed database points, without repeats while the database lasts
    pick = torch.randperm(spec.n, generator=g, device=dev)
    pick = pick[torch.arange(n_easy, device=dev) % spec.n]
    std = db.to(torch.float64).std(dim=0, unbiased=False).to(torch.float32)
    noise = torch.randn((n_easy, spec.d), generator=g, device=dev)
    q_easy = db[pick] + noise * (spec.jitter * std)
    queries = torch.empty((n_queries, spec.d), dtype=torch.float32, device=dev)
    queries[hard] = q_hard
    queries[~hard] = q_easy
    del q_easy, noise, pick
    scale = max(_median_nn_distance(db, queries[:_SCALE_QUERIES]) / spec.nn_target, 1e-12)
    db = (db / scale).contiguous()
    queries = (queries / scale).contiguous()
    del pts
    return Dataset(db=db, queries=queries, scale=scale)
