"""The plain reference that decides ``correct``: E2LSH on Storage's query,
from scratch, on the same database and the same hash family.

It imports nothing of the program. The hash family is drawn here from the
build seed with the draws the configuration's family rule states (a CPU
``torch.Generator``: normal projections, uniform shifts, odd uint32
multipliers, in that order); the tables are rebuilt from the database by
float64 projections; each query is hashed in float64 and walked through
its buckets in the paper's block order, ``block_objs`` entries a read and
at most ``max_chain`` reads a bucket, gated by the S budget at each step;
candidates get exact float64 distances and are merged into the running
top-k with id dedup; a query is done at the first radius with k results
within c*R.

What the reference cannot decide, it says so rather than guess: a query
whose float64 hash value lies within ``HASH_MARGIN`` of a floor() boundary
(in bucket widths) may land on either side in any float32 computation, and
a top-k distance within ``THRESH_TOL`` of the c*R threshold may fall on
either side of it. Such rows are marked ambiguous; the comparison leaves
their integer fields out and still checks every distance they report.

``precision="tf32"`` is the control: the same algorithm with the query's
projections and the candidate distances computed from operands rounded to
TF32 (10 mantissa bits, as the tensor cores take float32), which a
configuration stating float32 must refuse.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RefParams", "Family", "family_from_seed", "Reference", "RefResult",
           "fmix32", "combine_split", "to_tf32", "INVALID", "HASH_MARGIN",
           "THRESH_TOL"]

INVALID = 2**31 - 1
M32 = 0xFFFFFFFF
HASH_MARGIN = 1e-4   # bucket widths: float32 rounding of a projection is far below
THRESH_TOL = 2e-6    # of (|x| + |q|)^2: float32 rounding of a squared distance
_ROWS = 1 << 17      # database rows hashed at once
_CHUNK = 4096        # query rows walked at once


@dataclasses.dataclass(frozen=True)
class RefParams:
    """The index and query parameters a configuration states."""

    d: int
    m: int
    L: int
    r: int
    S: int
    u: int
    fp_bits: int
    w: float
    c: float
    block_objs: int
    max_chain: int
    k: int

    @property
    def radii(self) -> tuple:
        return tuple(float(self.c) ** t for t in range(self.r))

    @staticmethod
    def from_config(cfg: dict) -> "RefParams":
        e = cfg["index"]
        return RefParams(d=int(cfg["d"]), m=int(e["m"]), L=int(e["L"]), r=int(e["r"]),
                         S=int(e["S"]), u=int(e["u"]), fp_bits=int(e["fp_bits"]),
                         w=float(e["w"]), c=float(e["c"]),
                         block_objs=int(e["block_objs"]),
                         max_chain=int(e["max_chain"]), k=int(cfg["k"]))


@dataclasses.dataclass(frozen=True)
class Family:
    a: torch.Tensor    # [r, L, m, d] float32
    b: torch.Tensor    # [r, L, m] float32, shifts in [0, 1)
    rm: torch.Tensor   # [r, L, m] int64, odd uint32 multipliers

    def to(self, device) -> "Family":
        return Family(self.a.to(device), self.b.to(device), self.rm.to(device))


def family_from_seed(seed: int, p: RefParams) -> Family:
    """The hash family of build seed ``seed``: N(0, 1) projections, U[0, 1)
    shifts, then odd multipliers 2j + 1 with j uniform in [1, 2^31 - 1),
    drawn in that order from one CPU generator."""
    g = torch.Generator().manual_seed(int(seed))
    a = torch.randn((p.r, p.L, p.m, p.d), generator=g, dtype=torch.float32)
    b = torch.rand((p.r, p.L, p.m), generator=g, dtype=torch.float32)
    j = torch.randint(1, 2**31 - 1, (p.r, p.L, p.m), generator=g, dtype=torch.int64)
    return Family(a=a, b=b, rm=(j * 2 + 1) & M32)


# -- uint32 arithmetic on int64 tensors ------------------------------------------

def _mul32(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c in [0, 2^32), in 16-bit halves."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser."""
    h = h & M32
    h = h ^ (h >> 16)
    h = _mul32(h, torch.tensor(0x85EBCA6B, dtype=torch.int64, device=h.device))
    h = h ^ (h >> 13)
    h = _mul32(h, torch.tensor(0xC2B2AE35, dtype=torch.int64, device=h.device))
    return h ^ (h >> 16)


def combine_split(hj: torch.Tensor, rm: torch.Tensor, u: int, fp_bits: int):
    """hv = fmix32(sum_j rm_j * h_j mod 2^32); bucket = the low u bits,
    fingerprint = the next fp_bits. hj [..., m] integral, rm [..., m]."""
    prod = _mul32(hj.to(torch.int64) & M32, rm & M32)
    hv = fmix32(prod.sum(dim=-1))
    return hv & ((1 << u) - 1), (hv >> u) & ((1 << fp_bits) - 1)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & (M32 ^ 0x1FFF)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return bits.view(torch.float32)


@dataclasses.dataclass
class RefResult:
    """Per query row: the result fields, whether the reference could decide
    the row, and each radius's work (for the roofline counts)."""

    ids: torch.Tensor            # [Q, k] int64, INVALID where unfound
    d2: torch.Tensor             # [Q, k] float64, inf where unfound
    found: torch.Tensor          # [Q] bool
    radii_searched: torch.Tensor
    nio_table: torch.Tensor
    nio_blocks: torch.Tensor
    cands_checked: torch.Tensor
    ambiguous: torch.Tensor      # [Q] bool
    active: torch.Tensor         # [Q, r] bool: the row probed this radius
    blocks: torch.Tensor         # [Q, r] int64: chain blocks it read there
    cands: torch.Tensor          # [Q, r] int64: candidates it checked there

    def cpu(self) -> "RefResult":
        return RefResult(**{f.name: getattr(self, f.name).cpu()
                            for f in dataclasses.fields(RefResult)})


class Reference:
    """The reference over one database and family, on ``device``."""

    def __init__(self, db: torch.Tensor, family: Family, p: RefParams, *,
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {precision!r}")
        self.db = db.to(torch.float32)
        self.dev = self.db.device
        self.family = family.to(self.dev)
        self.p = p
        self.precision = precision
        self.db_norm = torch.sqrt((self.db.to(torch.float64) ** 2).sum(1))

    # -- the tables ------------------------------------------------------------
    def _db_hash(self, t: int):
        """Bucket and fingerprint of every database row at radius t, by the
        build rule floor((x.a + b * wR) / wR) in float64. [n, L] int64 each."""
        p, f = self.p, self.family
        a = f.a[t].to(torch.float64).reshape(p.L * p.m, p.d)
        wr = float(p.w) * float(p.radii[t])
        bwr = f.b[t].to(torch.float64) * wr
        wr_t = torch.tensor(wr, dtype=torch.float64, device=self.dev)
        out_b, out_f = [], []
        for s in range(0, self.db.shape[0], _ROWS):
            proj = (self.db[s:s + _ROWS].to(torch.float64) @ a.T).view(-1, p.L, p.m)
            hj = torch.floor((proj + bwr[None]) / wr_t)
            bk, fp = combine_split(hj, f.rm[t][None], p.u, p.fp_bits)
            out_b.append(bk)
            out_f.append(fp)
        return torch.cat(out_b), torch.cat(out_f)

    def _tables(self, t: int):
        """Radius t's buckets: for each table, the rows sorted by (bucket, id),
        as keys, ids and fingerprints [L, n]."""
        bucket, fp = self._db_hash(t)
        key, order = torch.sort(bucket.T.contiguous(), dim=1, stable=True)
        fps = torch.gather(fp.T.contiguous(), 1, order)
        return key, order, fps

    # -- the query side --------------------------------------------------------
    def _query_hash(self, q: torch.Tensor, t: int):
        """(bucket, fp [Q, L] int64, margin [Q, L] float64)."""
        p, f = self.p, self.family
        wr32 = torch.tensor(float(p.w) * float(p.radii[t]), dtype=torch.float32,
                            device=self.dev)
        bwr32 = f.b[t] * wr32                                   # [L, m]
        a = f.a[t].reshape(p.L * p.m, p.d)
        if self.precision == "tf32":
            proj = (to_tf32(q) @ to_tf32(a).T).view(-1, p.L, p.m)
            v = (proj + bwr32[None]) / wr32
            margin = torch.full(v.shape[:2], float("inf"), dtype=torch.float64,
                                device=self.dev)
        else:
            proj = (q.to(torch.float64) @ a.to(torch.float64).T).view(-1, p.L, p.m)
            v = (proj + bwr32.to(torch.float64)[None]) / wr32.to(torch.float64)
            margin = (v - torch.round(v)).abs().amin(dim=-1)
        bk, fp = combine_split(torch.floor(v), f.rm[t][None], p.u, p.fp_bits)
        return bk, fp, margin

    def _d2(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Squared distances of q [Q, d] to rows ids [Q, s] (valid ids)."""
        x = self.db[ids]                                        # [Q, s, d]
        if self.precision == "tf32":
            dot = torch.bmm(to_tf32(x), to_tf32(q)[:, :, None])[..., 0]
            xn2 = (x * x).sum(-1)
            qn2 = (q * q).sum(-1)
            return torch.clamp(xn2 - 2.0 * dot + qn2[:, None], min=0.0).to(torch.float64)
        diff = x.to(torch.float64) - q.to(torch.float64)[:, None, :]
        return (diff * diff).sum(-1)

    def exact_d2(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """float64 squared distances of q [Q, d] to db rows ids [Q, s] (any
        value; ids outside [0, n) give nan)."""
        n = self.db.shape[0]
        ok = (ids >= 0) & (ids < n)
        safe = torch.where(ok, ids, 0).to(torch.int64)
        diff = self.db[safe].to(torch.float64) - q.to(torch.float64)[:, None, :]
        d2 = (diff * diff).sum(-1)
        return torch.where(ok, d2, torch.nan)

    def _walk(self, q, qb, qfp, active, key, ids_t, fps_t):
        """One radius's chain walk for rows q: (cand [Q, S] int64, count,
        blocks read, non-empty buckets)."""
        p = self.p
        Q, L, BLK = qb.shape[0], p.L, p.block_objs
        n = key.shape[1]
        lo = torch.stack([torch.searchsorted(key[l], qb[:, l].contiguous())
                          for l in range(L)], dim=1)
        hi = torch.stack([torch.searchsorted(key[l], qb[:, l].contiguous(), right=True)
                          for l in range(L)], dim=1)
        cnt = hi - lo
        nonempty = (cnt > 0) & active[:, None]
        cand = torch.full((Q, p.S), INVALID, dtype=torch.int64, device=self.dev)
        count = torch.zeros((Q,), dtype=torch.int64, device=self.dev)
        blocks = torch.zeros((Q,), dtype=torch.int64, device=self.dev)
        slot = torch.arange(BLK, device=self.dev)
        base = (torch.arange(L, device=self.dev) * n)[None, :, None]
        for step in range(p.max_chain):
            read = nonempty & (cnt > step * BLK) & (count < p.S)[:, None]
            blocks += read.sum(1)
            pos = step * BLK + slot[None, None, :]
            ok = read[:, :, None] & (pos < cnt[:, :, None])
            flat = torch.where(ok, base + lo[:, :, None] + pos, 0).reshape(Q, -1)
            eid = ids_t.reshape(-1)[flat]
            hit = ok.reshape(Q, -1) & (fps_t.reshape(-1)[flat] == qfp.repeat_interleave(BLK, dim=1))
            rank = count[:, None] + torch.cumsum(hit.to(torch.int64), 1) - hit.to(torch.int64)
            keep = hit & (rank < p.S)
            col = torch.where(keep, rank, p.S)
            wide = torch.cat([cand, cand.new_full((Q, 1), INVALID)], dim=1)
            wide.scatter_(1, col, torch.where(keep, eid, INVALID))
            cand = wide[:, :p.S]
            count = torch.clamp(count + hit.sum(1), max=p.S)
        return cand, count, blocks, nonempty.sum(1)

    @staticmethod
    def _merge(best_id, best_d2, new_id, new_d2, k: int):
        """The running top-k merged with a candidate set, duplicates of one
        id counted once, ties kept in (best, new) and buffer order."""
        ids = torch.cat([best_id, new_id], 1)
        d2 = torch.cat([best_d2, new_d2], 1)
        order = torch.sort(ids, dim=1, stable=True).indices
        ids_s = torch.gather(ids, 1, order)
        d2_s = torch.gather(d2, 1, order)
        dup = torch.zeros_like(ids_s, dtype=torch.bool)
        dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
        d2_s = torch.where(dup | (ids_s == INVALID), torch.inf, d2_s)
        top = torch.sort(d2_s, dim=1, stable=True).indices[:, :k]
        out_d2 = torch.gather(d2_s, 1, top)
        out_id = torch.where(torch.isinf(out_d2), INVALID, torch.gather(ids_s, 1, top))
        return out_id, out_d2

    def answer(self, queries: torch.Tensor) -> RefResult:
        """The reference's result for every row of ``queries`` [Q, d]."""
        p = self.p
        q_all = queries.to(self.dev, torch.float32)
        Q, r, k = q_all.shape[0], p.r, p.k
        i64 = dict(dtype=torch.int64, device=self.dev)
        best_id = torch.full((Q, k), INVALID, **i64)
        best_d2 = torch.full((Q, k), torch.inf, dtype=torch.float64, device=self.dev)
        done = torch.zeros((Q,), dtype=torch.bool, device=self.dev)
        amb = torch.zeros_like(done)
        radii, nio_t, nio_b, nc = (torch.zeros((Q,), **i64) for _ in range(4))
        act, blk, cnd = (torch.zeros((Q, r), **i64) for _ in range(3))
        qn = torch.sqrt((q_all.to(torch.float64) ** 2).sum(1))
        for t in range(r):
            if bool(done.all()):
                break
            key, ids_t, fps_t = self._tables(t)
            thresh = (float(p.c) * float(p.radii[t])) ** 2
            for s in range(0, Q, _CHUNK):
                e = min(Q, s + _CHUNK)
                active = ~done[s:e]
                if not bool(active.any()):
                    continue
                q = q_all[s:e]
                qb, qfp, margin = self._query_hash(q, t)
                amb[s:e] |= active & (margin < HASH_MARGIN).any(1)
                cand, count, blocks, nonempty = self._walk(q, qb, qfp, active, key,
                                                           ids_t, fps_t)
                valid = cand != INVALID
                d2 = self._d2(q, torch.where(valid, cand, 0))
                d2 = torch.where(valid, d2, torch.inf)
                new_id, new_d2 = self._merge(best_id[s:e], best_d2[s:e], cand, d2, k)
                keep = ~active[:, None]
                best_id[s:e] = torch.where(keep, best_id[s:e], new_id)
                best_d2[s:e] = torch.where(keep, best_d2[s:e], new_d2)
                # a top-k distance this close to c*R may fall on either side
                # of the threshold in float32
                x_norm = self.db_norm[torch.where(best_id[s:e] == INVALID, 0,
                                                  best_id[s:e])]
                tol = THRESH_TOL * (x_norm + qn[s:e, None]) ** 2
                near = ((best_d2[s:e] - thresh).abs() <= tol) & torch.isfinite(best_d2[s:e])
                amb[s:e] |= active & near.any(1)
                within = (best_d2[s:e] <= thresh).sum(1) >= k
                radii[s:e] += active.to(torch.int64)
                nio_t[s:e] += nonempty
                nio_b[s:e] += blocks
                nc[s:e] += count
                act[s:e, t] = active.to(torch.int64)
                blk[s:e, t] = blocks
                cnd[s:e, t] = count
                done[s:e] |= within & active
            del key, ids_t, fps_t
        return RefResult(ids=best_id, d2=best_d2, found=done, radii_searched=radii,
                         nio_table=nio_t, nio_blocks=nio_b, cands_checked=nc,
                         ambiguous=amb, active=act.bool(), blocks=blk, cands=cnd)
