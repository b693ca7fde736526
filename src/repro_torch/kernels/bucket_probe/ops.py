"""bucket_probe wrapper and the index blockification.

``bucket_probe``: a CUDA tensor launches the hand-written kernel
(``csrc/bucket_probe.cu``), a CPU tensor runs the plain version.

``blockify_entries`` converts the contiguous CSR entry layout of
``core.index`` into the [NB, BLKp] block-store rows (the paper's 512 B
blocks) that the probe reads. It runs on whatever device its inputs lie on,
by one scatter over all entries (in bounded chunks), so a SIFT1M-scale index
is blockified on the card in the build.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import INVALID, bucket_probe_ref

__all__ = ["bucket_probe", "blockify_entries", "INVALID", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("bucket_probe", "bucket_probe_launch", [_P] * 5 + [_I] * 2 + [_P])

_CHUNK = 1 << 24  # entries per scatter step: bounds the int64 scratch to ~128 MB


def blockify_entries(entries_id, entries_fp, table_off, table_cnt,
                     block_objs: int, *, lane_pad: int):
    """Pack CSR entries into [NB, BLKp] block rows (BLKp = block_objs padded
    to ``lane_pad``) on the inputs' device.

    Returns (ids_blocks, fps_blocks, head_row, NB): int32 rows holding INVALID
    / -1 in unused slots, and head_row (the shape of table_off) with the first
    block row of each bucket, -1 if empty. A bucket's chunks occupy
    consecutive rows; row 0 is a spare that holds no entry, so callers can
    use it as safe padding.
    """
    dev = entries_id.device
    toff = table_off.reshape(-1).to(torch.int64)
    tcnt = table_cnt.reshape(-1).to(torch.int64)
    blkp = max(lane_pad, -(-block_objs // lane_pad) * lane_pad)
    sel = tcnt > 0
    offs = toff[sel]
    cnts = tcnt[sel]
    nblocks = (cnts + block_objs - 1) // block_objs
    head_rows = torch.cumsum(nblocks, 0) - nblocks + 1
    NB = int(nblocks.sum()) + 1
    ids_blocks = torch.full((NB, blkp), INVALID, dtype=torch.int32, device=dev)
    fps_blocks = torch.full((NB, blkp), -1, dtype=torch.int32, device=dev)
    head = torch.full(toff.shape, -1, dtype=torch.int32, device=dev)
    head[sel] = head_rows.to(torch.int32)
    ends = torch.cumsum(cnts, 0)  # inclusive: entries of buckets 0..i
    total = int(ends[-1]) if len(ends) else 0
    ids_flat, fps_flat = ids_blocks.view(-1), fps_blocks.view(-1)
    eid = entries_id.to(torch.int32)
    efp = entries_fp.to(torch.int32)
    for e0 in range(0, total, _CHUNK):
        e = torch.arange(e0, min(total, e0 + _CHUNK), dtype=torch.int64, device=dev)
        bkt = torch.searchsorted(ends, e, right=True)
        local = e - (ends[bkt] - cnts[bkt])
        src = offs[bkt] + local
        dst = (head_rows[bkt] + local // block_objs) * blkp + local % block_objs
        ids_flat[dst] = eid[src]
        fps_flat[dst] = efp[src]
    return ids_blocks, fps_blocks, head.view(table_off.shape), NB


def bucket_probe(block_rows, qfp, ids_blocks, fps_blocks):
    """Fetch + fingerprint-filter a list of bucket block rows.

    block_rows [G] int32 (0 <= row < NB; row 0 is the empty spare used as
    padding), qfp [G] int32, ids/fps_blocks [NB, BLKp] int32.
    Returns [G, BLKp] int32 with INVALID in non-matching slots.
    """
    if not use_kernel(block_rows, qfp, ids_blocks, fps_blocks):
        return bucket_probe_ref(block_rows, qfp, ids_blocks, fps_blocks)
    for name, t, nd in (("block_rows", block_rows, 1), ("qfp", qfp, 1),
                        ("ids_blocks", ids_blocks, 2), ("fps_blocks", fps_blocks, 2)):
        check_operand("bucket_probe", name, t, torch.int32, nd)
    G = block_rows.shape[0]
    NB, blkp = ids_blocks.shape
    if qfp.shape[0] != G or fps_blocks.shape != ids_blocks.shape:
        raise ValueError(f"bucket_probe: shapes disagree: rows {G}, qfp "
                         f"{tuple(qfp.shape)}, ids {tuple(ids_blocks.shape)}, "
                         f"fps {tuple(fps_blocks.shape)}")
    if blkp % 4 or ids_blocks.data_ptr() % 16 or fps_blocks.data_ptr() % 16:
        raise ValueError(f"bucket_probe: rows must be whole 16 B vectors "
                         f"(BLKp={blkp} must be a multiple of 4, 16 B-aligned)")
    out = torch.empty((G, blkp), dtype=torch.int32, device=ids_blocks.device)
    if G:
        with torch.cuda.device(ids_blocks.device):
            KERNEL(block_rows.data_ptr(), qfp.data_ptr(), ids_blocks.data_ptr(),
                   fps_blocks.data_ptr(), out.data_ptr(), G, blkp,
                   torch.cuda.current_stream(ids_blocks.device).cuda_stream)
    return out
