"""lsh_hash wrapper: a CUDA tensor launches the hand-written kernel
(``csrc/lsh_hash.cu``), a CPU tensor runs the plain version (``ref.py``).

``lsh_hash_all_radii`` hashes the whole radius schedule in one launch (the
fused query plan's Step 1): [r, L, m] hash functions flatten into r*L*m
projection columns, each carrying its own width w*R.

Both run over a :class:`HashPack`: the kernel's column operands, built once
per index and radius schedule (:func:`index_hash_pack`) and reused by every
batch of the fused and external plans, as the reference's wrapper packs them
(``src/repro/kernels/lsh_hash/ops.py``: ``rm = 0`` and ``wr = 1`` in padding
columns) with the shift ``b*wR`` multiplied once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import lsh_hash_packed_ref

__all__ = ["lsh_hash_all_radii", "hash_pack", "index_hash_pack", "packed_width",
           "HashPack", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("lsh_hash", "lsh_hash_launch", [_P] * 7 + [_I] * 6 + [_P])

# csrc/lsh_hash.cu's block width in columns: a hash's padded width must divide
# it, so that no hash straddles two blocks.
_BLOCK_COLUMNS = 96


def packed_width(m: int) -> int:
    """The padded column count of one hash: the least multiple of 4 that
    divides the kernel's block width and is at least m (23 -> 24, 13 -> 16,
    6 -> 8, 1 -> 4). Past the block (m > 96, which only the plain version
    serves) it is m rounded up to a multiple of 4."""
    return next((mp for mp in range(4, _BLOCK_COLUMNS + 1, 4)
                 if mp >= m and _BLOCK_COLUMNS % mp == 0), -(-m // 4) * 4)


@dataclasses.dataclass(frozen=True)
class HashPack:
    """The hash family as the kernel reads it: r*L hashes of ``mp`` columns.

    a [r*L*mp, D] f32 (padding rows 0); bwr = b*wR, wr = w*R [r*L*mp] f32
    (0 and 1 in padding); rm [r*L*mp] int32 (0 in padding)."""
    a: torch.Tensor
    bwr: torch.Tensor
    wr: torch.Tensor
    rm: torch.Tensor
    r: int
    L: int
    m: int
    mp: int


def hash_pack(a, b, rm, *, w: float, radii) -> HashPack:
    """The pack of hash family a [r, L, m, D], b/rm [r, L, m] under the
    schedule ``radii``."""
    r, L, m, D = a.shape
    mp = packed_width(m)
    dev = a.device
    # per-column width: radius t owns hashes [t*L, (t+1)*L); the shift is
    # pre-multiplied, b * (w*R) in f32, as the reference's ops.py packs it
    wr_t = torch.tensor([float(w) * float(rad) for rad in radii], dtype=torch.float32,
                        device=dev)[:, None, None]
    a_p = torch.zeros((r, L, mp, D), dtype=torch.float32, device=dev)
    a_p[:, :, :m] = a
    bwr = torch.zeros((r, L, mp), dtype=torch.float32, device=dev)
    bwr[:, :, :m] = b.to(torch.float32) * wr_t
    wr = torch.ones((r, L, mp), dtype=torch.float32, device=dev)
    wr[:, :, :m] = wr_t
    rm_p = torch.zeros((r, L, mp), dtype=torch.int32, device=dev)
    rm_p[:, :, :m] = rm
    return HashPack(a=a_p.reshape(r * L * mp, D), bwr=bwr.reshape(-1), wr=wr.reshape(-1),
                    rm=rm_p.reshape(-1), r=r, L=L, m=m, mp=mp)


_INDEX_PACKS = {}   # id(index) -> {(w, radii): HashPack}, dropped with the index


def index_hash_pack(index, *, w: float, radii) -> HashPack:
    """The pack of an index's family (its ``a``, ``b``, ``rm``) under the
    schedule ``radii``: built at the index's first batch and reused by every
    later one while the index lives."""
    packs = _INDEX_PACKS.get(id(index))
    if packs is None:
        packs = _INDEX_PACKS[id(index)] = {}
        weakref.finalize(index, _INDEX_PACKS.pop, id(index), None)
    key = (float(w), tuple(float(x) for x in radii))
    if key not in packs:
        packs[key] = hash_pack(index.a, index.b, index.rm, w=w, radii=radii)
    return packs[key]


def lsh_hash_all_radii(x, a, b, rm, *, w: float, radii, u: int, fp_bits: int,
                       pack: HashPack | None = None):
    """Hash points under the full radius schedule in one launch.

    x [N, D] f32; a [r, L, m, D] f32; b [r, L, m] in [0, 1); rm [r, L, m]
    int32 (uint32 bit patterns); radii = the schedule.
    ``pack`` is the family's :class:`HashPack` under this schedule where the
    caller keeps one (the plans pass their index's, :func:`index_hash_pack`);
    it is built here otherwise. The kernel takes m <= 96.
    Returns (bucket, fp) [r, N, L] int32, the layout of stacking the
    per-radius results.
    """
    kernel = use_kernel(x, a, b, rm)
    if kernel:
        for name, t, dtype, nd in (("x", x, torch.float32, 2), ("a", a, torch.float32, 4),
                                   ("rm", rm, torch.int32, 3)):
            check_operand("lsh_hash", name, t, dtype, nd)
    N, D = x.shape
    r, L, m, _ = a.shape
    if a.shape[3] != D or b.shape != (r, L, m) or rm.shape != (r, L, m) or len(radii) != r:
        raise ValueError(f"lsh_hash: shapes disagree: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, rm {tuple(rm.shape)}, "
                         f"{len(radii)} radii")
    if not (0 < u < 32 and 0 <= fp_bits < 32 and u + fp_bits <= 32):
        raise ValueError(f"lsh_hash: need 0 < u < 32 and u + fp_bits <= 32, "
                         f"got u={u} fp_bits={fp_bits}")
    if pack is None:
        pack = hash_pack(a, b, rm, w=w, radii=radii)
    elif (pack.r, pack.L, pack.m, pack.a.shape[1]) != (r, L, m, D):
        raise ValueError(f"lsh_hash: the pack holds r={pack.r} L={pack.L} m={pack.m} "
                         f"D={pack.a.shape[1]}, the family a {tuple(a.shape)}")
    if not kernel:
        return lsh_hash_packed_ref(x, pack, u=u, fp_bits=fp_bits)
    if _BLOCK_COLUMNS % pack.mp:
        raise ValueError(f"lsh_hash: the kernel takes at most {_BLOCK_COLUMNS} hash "
                         f"functions per table, got m = {m}")
    n_hashes = r * L
    bucket = torch.empty((N, n_hashes), dtype=torch.int32, device=x.device)
    fp = torch.empty((N, n_hashes), dtype=torch.int32, device=x.device)
    if N:
        with torch.cuda.device(x.device):
            KERNEL(x.data_ptr(), pack.a.data_ptr(), pack.bwr.data_ptr(), pack.wr.data_ptr(),
                   pack.rm.data_ptr(), bucket.data_ptr(), fp.data_ptr(),
                   N, D, n_hashes, pack.mp, u, fp_bits,
                   torch.cuda.current_stream(x.device).cuda_stream)
    # [N, r*L] -> [r, N, L]: columns are (t, l) ordered
    return bucket.view(N, r, L).permute(1, 0, 2), fp.view(N, r, L).permute(1, 0, 2)
