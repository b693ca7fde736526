"""Compound p-stable hashing: the family, and the float64 build hash.

Pipeline (paper Secs. 2.2, 2.3, 5.2), for radius R and table l:

    proj_j = a_{l,j} . x
    h_j    = floor((proj_j + b_{l,j} * w * R) / (w * R))   j = 1..m
    hv32   = fmix32( sum_j rm_{l,j} * h_j )                (wrapping uint32)
    bucket = hv32 & (2^u - 1)
    fp     = (hv32 >> u) & (2^fp_bits - 1)

The uint32 arithmetic lives in ``kernels.lsh_hash.ref`` (int64 tensors
masked to 32 bits; torch's int32 shifts sign-extend).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels.lsh_hash.ref import combine_split, fmix32, lsh_hash_ref, true_div

__all__ = ["HashFamily", "make_hash_family", "hash_points_radius", "hash_points",
           "hash_points_radius_deterministic", "fmix32"]


def _uint32_bits_to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bit pattern."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class HashFamily:
    """Random parameters for r x L compound hashes of m functions each.

    a:  [r, L, m, d] float32  p-stable (Gaussian) projection vectors
    b:  [r, L, m]    float32  shifts in [0, 1) (scaled by w*R at use site)
    rm: [r, L, m]    int32    odd uint32 multipliers, stored as their int32
                              bit patterns (the kernel reads them so; the
                              reference holds the same values as uint32)
    """

    a: torch.Tensor
    b: torch.Tensor
    rm: torch.Tensor
    w: float
    u: int
    fp_bits: int

    @property
    def r(self) -> int:
        return self.a.shape[0]

    @property
    def L(self) -> int:
        return self.a.shape[1]

    @property
    def m(self) -> int:
        return self.a.shape[2]

    @property
    def d(self) -> int:
        return self.a.shape[3]

    @staticmethod
    def from_numpy(a, b, rm, *, w: float, u: int, fp_bits: int,
                   device) -> "HashFamily":
        """Carry a family across from numpy (the reference's ``a``/``b``/``rm``
        leaves; ``rm`` as uint32 or as int32 bit patterns)."""
        rm64 = torch.from_numpy(np.asarray(rm).astype(np.int64) & 0xFFFFFFFF)
        return HashFamily(
            a=torch.from_numpy(np.array(a, np.float32, order="C")).to(device),
            b=torch.from_numpy(np.array(b, np.float32, order="C")).to(device),
            rm=_uint32_bits_to_int32(rm64).to(device),
            w=float(w), u=int(u), fp_bits=int(fp_bits))


def make_hash_family(*, r: int, L: int, m: int, d: int, w: float, u: int,
                     fp_bits: int, generator: torch.Generator,
                     device) -> HashFamily:
    """Draw a family from ``generator`` (a CPU ``torch.Generator``, so the
    draw is the same whatever the device) and place it on ``device``.

    torch cannot reproduce the reference's ``jax.random`` draws; parity
    tests inject the reference's family through ``HashFamily.from_numpy``.
    """
    a = torch.randn((r, L, m, d), generator=generator, dtype=torch.float32)
    b = torch.rand((r, L, m), generator=generator, dtype=torch.float32)
    rm = torch.randint(1, 2**31 - 1, (r, L, m), generator=generator,
                       dtype=torch.int64)
    rm = _uint32_bits_to_int32(rm * 2 + 1)  # odd multipliers
    return HashFamily(a=a.to(device), b=b.to(device), rm=rm.to(device),
                      w=float(w), u=int(u), fp_bits=int(fp_bits))


def hash_points_radius_deterministic(family: HashFamily, x: torch.Tensor,
                                     t: int, radius: float):
    """Build-path hashing with float64 projections, on x's device.

    float64 accumulation shrinks order-dependent rounding to ~1e-14
    relative, far below any realizable floor() boundary gap, and everything
    after floor() is exact integer math, so the index is the same whichever
    device, library or thread count computed it — and the same as the
    reference's host build given the same family.

    x [N, d]. Returns (bucket, fp) [N, L] int32.
    """
    a = family.a[t].to(torch.float64)                 # [L, m, d]
    L, m, d = a.shape
    wr = float(family.w) * float(radius)
    proj = x.to(torch.float64) @ a.reshape(L * m, d).T   # [N, L*m]
    bwr = family.b[t].to(torch.float64)[None] * wr
    hj = torch.floor(true_div(proj.view(-1, L, m) + bwr, wr))
    return combine_split(hj, family.rm[t][None], family.u, family.fp_bits)


def hash_points_radius(family: HashFamily, x: torch.Tensor, t: int, radius: float):
    """Query-time hashing of points [N, d] under radius index ``t``, with
    float32 projections in the reference's op order (``floor((x.a + b*wR) /
    wR)``), on x's device. Returns (bucket, fp) [N, L] int32."""
    return lsh_hash_ref(x, family.a[t], family.b[t], family.rm[t],
                        w_r=float(family.w) * float(radius), u=family.u,
                        fp_bits=family.fp_bits)


def hash_points(family: HashFamily, x: torch.Tensor, radii) -> tuple:
    """``hash_points_radius`` under every radius: (bucket, fp) [r, N, L]."""
    out = [hash_points_radius(family, x, t, float(radius)) for t, radius in enumerate(radii)]
    return torch.stack([b for b, _ in out]), torch.stack([f for _, f in out])
