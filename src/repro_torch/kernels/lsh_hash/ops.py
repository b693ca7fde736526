"""lsh_hash wrapper: a CUDA tensor launches the hand-written kernel
(``csrc/lsh_hash.cu``), a CPU tensor runs the plain version (``ref.py``).

``lsh_hash_lookup`` is the query plans' Step 1 in one launch: it hashes the
whole radius schedule ([r, L, m] hash functions flatten into r*L*m projection
columns, each carrying its own width w*R) and, in the kernel's epilogue, reads
every bucket's size and chain head from the index's tables, writing
(cnt, head, fp) [r, N, L]. ``lsh_hash_all_radii`` is the same launch without
the tables, returning (bucket, fp) [r, N, L].

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
from .ref import lsh_hash_lookup_ref, lsh_hash_packed_ref

__all__ = ["lsh_hash_all_radii", "lsh_hash_lookup", "hash_pack", "index_hash_pack",
           "packed_width", "HashPack", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("lsh_hash", "lsh_hash_launch", [_P] * 10 + [_I] * 7 + [_P])

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
    later one while the index lives. The key is ``(w, tuple(radii))``, which
    costs nothing for a schedule that is a tuple already (as
    ``QueryConfig.radii`` is)."""
    packs = _INDEX_PACKS.get(id(index))
    if packs is None:
        packs = _INDEX_PACKS[id(index)] = {}
        weakref.finalize(index, _INDEX_PACKS.pop, id(index), None)
    key = (w, tuple(radii))
    pack = packs.get(key)
    if pack is None:
        pack = packs[key] = hash_pack(index.a, index.b, index.rm, w=w, radii=radii)
    return pack


def _check_bits(u: int, fp_bits: int) -> None:
    if not (0 < u < 32 and 0 <= fp_bits < 32 and u + fp_bits <= 32):
        raise ValueError(f"lsh_hash: need 0 < u < 32 and u + fp_bits <= 32, "
                         f"got u={u} fp_bits={fp_bits}")


def _launch(x, pack: HashPack, tables, outs, u: int, fp_bits: int) -> None:
    """One kernel launch on x's device's current stream: ``tables`` is
    (table_cnt, blocks_head) or None, ``outs`` the three [r, N, L] outputs
    (the second unused without tables)."""
    if _BLOCK_COLUMNS % pack.mp:
        raise ValueError(f"lsh_hash: the kernel takes at most {_BLOCK_COLUMNS} hash "
                         f"functions per table, got m = {pack.m}")
    N, D = x.shape
    if not N:
        return
    tcnt, thead = (None, None) if tables is None else (t.data_ptr() for t in tables)
    args = (x.data_ptr(), pack.a.data_ptr(), pack.bwr.data_ptr(), pack.wr.data_ptr(),
            pack.rm.data_ptr(), tcnt, thead, *(o.data_ptr() for o in outs),
            N, D, pack.r, pack.L, pack.mp, u, fp_bits)
    # the current stream's raw handle, and the device guard only where another
    # device is current (the Stream object and the guard cost more host time
    # than the launch itself)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        KERNEL(*args, stream)
    else:
        with torch.cuda.device(index):
            KERNEL(*args, stream)


def lsh_hash_lookup(x, pack: HashPack, table_cnt, blocks_head, *, u: int, fp_bits: int):
    """Step 1 of the query plans: hash x under the pack's whole radius
    schedule and look up every bucket, in one launch on the card.

    x [N, D] f32; ``pack`` the family's :class:`HashPack` under the schedule
    (:func:`index_hash_pack`); table_cnt and blocks_head [r, L, 2^u] int32,
    contiguous: each bucket's size and its chain's first block row (-1 where
    empty). Returns (cnt, head, fp) [r, N, L] int32, each contiguous, so a
    radius' [N, L] rows are contiguous too.

    A CUDA x launches the kernel once on the current stream (the hashes are
    :func:`lsh_hash_all_radii`'s bit for bit; the lookup is in its epilogue)
    into one allocation; a CPU x runs the plain version
    (``ref.lsh_hash_lookup_ref``). Bad tables raise on either device, before
    any launch. The kernel takes m <= 96.
    """
    kernel = use_kernel(x, pack.a, table_cnt, blocks_head)
    r, L = pack.r, pack.L
    if x.dim() != 2 or x.shape[1] != pack.a.shape[1]:
        raise ValueError(f"lsh_hash: x {tuple(x.shape)} is not [N, {pack.a.shape[1]}]")
    _check_bits(u, fp_bits)
    for name, t in (("table_cnt", table_cnt), ("blocks_head", blocks_head)):
        check_operand("lsh_hash", name, t, torch.int32, 3)
        if t.shape != (r, L, 1 << u):
            raise ValueError(f"lsh_hash: {name} must be [r, L, 2^u] = [{r}, {L}, {1 << u}], "
                             f"got {tuple(t.shape)}")
    if not kernel:
        return lsh_hash_lookup_ref(x, pack, table_cnt, blocks_head, u=u, fp_bits=fp_bits)
    check_operand("lsh_hash", "x", x, torch.float32, 2)
    out = torch.empty((3, r, x.shape[0], L), dtype=torch.int32, device=x.device)
    outs = out.unbind(0)
    _launch(x, pack, (table_cnt, blocks_head), outs, u, fp_bits)
    return outs


def lsh_hash_all_radii(x, a, b, rm, *, w: float, radii, u: int, fp_bits: int,
                       pack: HashPack | None = None):
    """Hash points under the full radius schedule in one launch.

    x [N, D] f32; a [r, L, m, D] f32; b [r, L, m] in [0, 1); rm [r, L, m]
    int32 (uint32 bit patterns); radii = the schedule.
    ``pack`` is the family's :class:`HashPack` under this schedule where the
    caller keeps one (:func:`index_hash_pack`); it is built here otherwise.
    The kernel takes m <= 96.
    Returns (bucket, fp) [r, N, L] int32, contiguous, the layout of stacking
    the per-radius results. (The query plans call :func:`lsh_hash_lookup`,
    which reads the tables at the buckets in the same launch.)
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
    _check_bits(u, fp_bits)
    if pack is None:
        pack = hash_pack(a, b, rm, w=w, radii=radii)
    elif (pack.r, pack.L, pack.m, pack.a.shape[1]) != (r, L, m, D):
        raise ValueError(f"lsh_hash: the pack holds r={pack.r} L={pack.L} m={pack.m} "
                         f"D={pack.a.shape[1]}, the family a {tuple(a.shape)}")
    if not kernel:
        return lsh_hash_packed_ref(x, pack, u=u, fp_bits=fp_bits)
    out = torch.empty((2, r, N, L), dtype=torch.int32, device=x.device)
    bucket, fp = out.unbind(0)
    _launch(x, pack, None, (bucket, bucket, fp), u, fp_bits)
    return bucket, fp
