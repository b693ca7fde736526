"""Collision-probability law and Eq.-5 parameterization of E2LSH.

Implements the p-stable LSH collision probability p_w(s) of Datar et al. [11]
for the hash family  h(o) = floor((a.o + b) / w),  a ~ N(0, I_d), b ~ U[0, w):

    p_w(s) = Pr[h(o1) = h(o2)]  with s = ||o1 - o2||
           = 1 - 2*Phi(-w/s) - (2 / (sqrt(2*pi) * (w/s))) * (1 - exp(-(w/s)^2 / 2))

and the parameter rules of the paper (Sec. 2.3, Eq. 5):

    m = gamma * log_{1/p2} n,   L = n^rho,   S = 2L,
    rho = log(1/p1) / log(1/p2),  p1 = p_w(R)|_{R=1},  p2 = p_w(cR)|_{R=1}.

The paper's gamma scaling (Sec. 3.3) trades accuracy for compute without
changing the index size (L fixed once rho is fixed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

__all__ = [
    "collision_probability",
    "rho",
    "LSHParams",
    "solve_params",
    "radii_schedule",
]


def _phi(x: np.ndarray | float) -> np.ndarray | float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(x, dtype=np.float64) / math.sqrt(2.0)))


def collision_probability(s, w):
    """p_w(s): probability two points at distance s share a 1-D p-stable hash.

    Monotonically decreasing in s; p -> 1 as s -> 0; p -> 0 as s -> inf.
    Vectorized over `s` and/or `w`.
    """
    s = np.asarray(s, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    u = np.where(s > 0, w / np.maximum(s, 1e-300), np.inf)
    with np.errstate(over="ignore", invalid="ignore"):
        term_cdf = 2.0 * _phi(-u)
        term_pdf = (2.0 / (math.sqrt(2.0 * math.pi) * u)) * (1.0 - np.exp(-(u * u) / 2.0))
        p = 1.0 - term_cdf - term_pdf
    p = np.where(np.isinf(u), 1.0, p)  # s == 0 collides surely
    return np.clip(p, 0.0, 1.0)


def rho(c: float, w: float) -> float:
    """rho = ln(1/p1)/ln(1/p2) for radius-normalized distances (R=1)."""
    p1 = float(collision_probability(1.0, w))
    p2 = float(collision_probability(c, w))
    return math.log(1.0 / p1) / math.log(1.0 / p2)


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Resolved E2LSH parameters for one dataset (paper Eq. 5 + Sec. 3.3)."""

    n: int              # database size
    d: int              # dimensionality
    c: float            # approximation ratio (paper uses c = 2)
    w: float            # bucket width (sets rho)
    gamma: float        # accuracy scaling on m (Sec. 3.3)
    m: int              # hash functions per compound hash
    L: int              # number of compound hashes (tables)
    S: int              # candidate examination cap per (R, c)-NN instance
    r: int              # number of radii in the schedule
    radii: tuple        # (1, c, c^2, ..., c^(r-1))
    u: int              # hash-table address bits (paper Sec. 5.2)
    v: int              # total hash-value bits (32 in the paper)
    p1: float
    p2: float
    rho: float
    block_bytes: int    # storage read block size B (512 in the paper)
    block_objs: int     # object infos per block: (B - header) / entry
    seed: int = 0

    @property
    def fp_bits(self) -> int:
        """Fingerprint bits actually checked (paper: v - u; we store <= 16)."""
        return min(self.v - self.u, 16)

    def hash_table_entries(self) -> int:
        return self.r * self.L * (1 << self.u)

    def index_entry_count(self) -> int:
        """Total object infos across the index: n objects x L tables x r radii."""
        return self.n * self.L * self.r


# Paper Sec. 5.1 constants: 512 B blocks, 16 B header, 5 B object info -> 99 objs.
BLOCK_HEADER_BYTES = 16
OBJECT_INFO_BYTES = 5


def block_objs_for(block_bytes: int) -> int:
    return max(1, (block_bytes - BLOCK_HEADER_BYTES) // OBJECT_INFO_BYTES)


def radii_schedule(x_max: float, d: int, c: float) -> tuple:
    """R_max = 2 * x_max * sqrt(d); r = ceil(log_c R_max) (paper Sec. 2.3)."""
    r_max = 2.0 * float(x_max) * math.sqrt(float(d))
    r = max(1, int(math.ceil(math.log(max(r_max, c), c))))
    return tuple(float(c) ** t for t in range(r))


def solve_params(
    n: int,
    d: int,
    *,
    c: float = 2.0,
    w: float = 4.0,
    gamma: float = 1.0,
    x_max: float = 1.0,
    u_bits: int | None = None,
    v_bits: int = 32,
    block_bytes: int = 512,
    s_scale: float = 1.0,
    max_m: int = 64,
    max_L: int = 256,
    seed: int = 0,
) -> LSHParams:
    """Resolve (m, L, S, r, u) from (n, c, w, gamma) per Eq. 5 / Secs. 3.3, 5.2.

    `s_scale` scales S (the paper compensates the gamma scaling via S choice).
    `u_bits` defaults to "slightly smaller than log2(n)" (Sec. 5.2).
    """
    p1 = float(collision_probability(1.0, w))
    p2 = float(collision_probability(c, w))
    if not (0.0 < p2 < p1 < 1.0):
        raise ValueError(f"degenerate collision probabilities p1={p1}, p2={p2}; adjust w")
    rho_val = math.log(1.0 / p1) / math.log(1.0 / p2)
    m = int(math.ceil(gamma * math.log(n) / math.log(1.0 / p2)))
    m = max(1, min(m, max_m))
    L = int(math.ceil(n ** rho_val))
    L = max(1, min(L, max_L))
    S = max(1, int(math.ceil(s_scale * 2 * L)))
    radii = radii_schedule(x_max, d, c)
    if u_bits is None:
        # "slightly smaller than log2 n as long as it does not substantially
        # increase false collisions" (Sec. 5.2). We use log2(n) - 1, floored.
        u_bits = max(8, min(int(math.floor(math.log2(max(n, 256)))) - 1, v_bits - 2))
    return LSHParams(
        n=n,
        d=d,
        c=float(c),
        w=float(w),
        gamma=float(gamma),
        m=m,
        L=L,
        S=S,
        r=len(radii),
        radii=radii,
        u=int(u_bits),
        v=int(v_bits),
        p1=p1,
        p2=p2,
        rho=rho_val,
        block_bytes=int(block_bytes),
        block_objs=block_objs_for(block_bytes),
        seed=seed,
    )


def success_probability(m: int, L: int, p1: float) -> float:
    """Lower bound on per-radius success: 1 - (1 - p1^m)^L (near objects caught)."""
    return 1.0 - (1.0 - p1 ** m) ** L


def expected_far_collisions(n: int, m: int, L: int, p2: float) -> float:
    """Expected far-object candidates per radius: n * L * p2^m (drives S)."""
    return float(n) * L * (p2 ** m)
