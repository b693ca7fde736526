"""Plain PyTorch version of the lsh_hash kernel (and the hash arithmetic the
whole port shares).

torch has no full-featured uint32, and it shifts int32 arithmetically, so
``h >> 16`` on an int32 holding a uint32 bit pattern would sign-extend. Every
uint32 step here therefore runs on int64 tensors holding values in
[0, 2^32), and each product is split so that no intermediate leaves int64.
"""
from __future__ import annotations

import torch

__all__ = ["fmix32", "combine_split", "true_div", "lsh_hash_ref",
           "lsh_hash_all_radii_ref", "lsh_hash_packed_ref", "table_lookup_ref",
           "lsh_hash_lookup_ref", "floor_margin"]

M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c in [0, 2^32): split h into 16-bit halves so
    each partial product stays below 2^48."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h & M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def combine_split(hj: torch.Tensor, rm: torch.Tensor, u: int, fp_bits: int):
    """Wrapping multiply-add combine of the m per-function hashes, fmix32,
    and the bucket/fingerprint split.

    hj [..., m] integer floor values; rm broadcastable [..., m], int32 bit
    patterns or int64 values of the uint32 multipliers.
    Returns (bucket, fp) [...] int32.
    """
    prod = _mul32(hj.to(torch.int64) & M32, rm.to(torch.int64) & M32)
    hv = fmix32(prod.sum(dim=-1))
    bucket = (hv & ((1 << u) - 1)).to(torch.int32)
    fp = ((hv >> u) & ((1 << fp_bits) - 1)).to(torch.int32)
    return bucket, fp


def true_div(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value`` by an IEEE division in t's dtype. The divisor is a tensor
    on t's device: PyTorch's CUDA kernels turn division by a CPU scalar into
    a multiply by its reciprocal, which rounds differently and would move
    floor() boundaries."""
    return t / torch.tensor(value, dtype=t.dtype, device=t.device)


def lsh_hash_ref(x, a, b, rm, *, w_r: float, u: int, fp_bits: int):
    """x [N, D], a [L, m, D], b [L, m], rm [L, m] -> (bucket, fp) [N, L] int32.

    The reference's op order: floor((x.a + b*wR) / wR) in float32."""
    proj = torch.einsum("nd,lmd->nlm", x.to(torch.float32), a.to(torch.float32))
    wr = torch.tensor(w_r, dtype=torch.float32, device=x.device)
    hj = torch.floor((proj + b.to(torch.float32)[None] * wr) / wr)
    return combine_split(hj, rm[None], u, fp_bits)


def lsh_hash_all_radii_ref(x, a, b, rm, *, w: float, radii, u: int, fp_bits: int):
    """All-radius plain version: x [N, D], a [r, L, m, D], b/rm [r, L, m]
    -> (bucket, fp) [r, N, L] int32, one per-radius einsum each (the oracle
    plan hashes with exactly these calls)."""
    out = [lsh_hash_ref(x, a[t], b[t], rm[t], w_r=float(w) * float(radius),
                        u=u, fp_bits=fp_bits)
           for t, radius in enumerate(radii)]
    return (torch.stack([bk for bk, _ in out]), torch.stack([fp for _, fp in out]))


def lsh_hash_packed_ref(x, pack, *, u: int, fp_bits: int):
    """The plain version over the kernel's operands (``ops.HashPack``):
    x [N, D] -> (bucket, fp) [r, N, L] int32.

    Each radius's projection is the oracle's einsum over the pack's real
    columns, so the result is bit for bit :func:`lsh_hash_all_radii_ref`'s;
    the quantisation and combine then run over every packed column, where a
    padding column (a = 0, bwr = 0, wr = 1, rm = 0) adds floor(0/1) * 0 = 0."""
    r, L, m, mp = pack.r, pack.L, pack.m, pack.mp
    N, D = x.shape
    a = pack.a.view(r, L, mp, D)
    x = x.to(torch.float32)
    proj = torch.zeros((r, N, L, mp), dtype=torch.float32, device=x.device)
    for t in range(r):
        proj[t, :, :, :m] = torch.einsum("nd,lmd->nlm", x, a[t, :, :m].contiguous())
    hj = torch.floor((proj + pack.bwr.view(r, 1, L, mp)) / pack.wr.view(r, 1, L, mp))
    return combine_split(hj, pack.rm.view(r, 1, L, mp), u, fp_bits)


def table_lookup_ref(table_cnt, blocks_head, bucket_all, *, u: int):
    """Bucket sizes and chain-head rows for every (radius, query, table) in
    two gathers: tables [r, L, 2^u], bucket_all [r, Q, L] -> (cnt, head)
    [r, Q, L], each read at the flat index ((t*L + l) << u) + bucket."""
    r, _, L = bucket_all.shape
    dev = bucket_all.device
    tl = (torch.arange(r, device=dev, dtype=torch.int64)[:, None, None] * L
          + torch.arange(L, device=dev, dtype=torch.int64)[None, None, :])
    flat = (tl << u) + bucket_all.to(torch.int64)
    return table_cnt.reshape(-1)[flat], blocks_head.reshape(-1)[flat]


def lsh_hash_lookup_ref(x, pack, table_cnt, blocks_head, *, u: int, fp_bits: int):
    """The plain version of ``ops.lsh_hash_lookup``: :func:`lsh_hash_packed_ref`,
    then :func:`table_lookup_ref` at its buckets. x [N, D] -> (cnt, head,
    fp) [r, N, L] int32, contiguous."""
    bucket, fp = lsh_hash_packed_ref(x, pack, u=u, fp_bits=fp_bits)
    return (*table_lookup_ref(table_cnt, blocks_head, bucket, u=u), fp)


def floor_margin(x, a, b, *, w: float, radii) -> torch.Tensor:
    """For each compound hash, the distance of its nearest component from a
    floor() boundary, in units of the bucket width: min over m of
    |v - round(v)| with v = (x.a + b*wR) / wR, computed in float64 from the
    float32 values a kernel sees. Returns [r, N, L] float64.

    Two float32 projections of the same inputs differ by rounding only, so a
    compound hash whose margin exceeds that rounding (1e-4 is far above it
    at the widths the port runs) must hash identically in any summation
    order; below it, a bucket flip is legitimate and is counted, not
    hidden."""
    r, L, m, D = a.shape
    N = x.shape[0]
    wr32 = torch.tensor([float(w) * float(rad) for rad in radii], dtype=torch.float32,
                        device=x.device)
    bwr = (b.to(torch.float32) * wr32[:, None, None]).to(torch.float64)  # [r, L, m]
    proj = x.to(torch.float64) @ a.reshape(r * L * m, D).to(torch.float64).T
    v = (proj.view(N, r, L, m) + bwr[None]) / wr32.to(torch.float64)[None, :, None, None]
    return (v - torch.round(v)).abs().amin(dim=-1).permute(1, 0, 2)
