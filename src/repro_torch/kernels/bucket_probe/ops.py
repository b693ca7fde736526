"""The fused probe's wrapper and the index blockification.

``probe_append``: one radius of the fused probe (chain-row gather,
fingerprint filter, S-budget gate, ordered compact append). A CUDA tensor
launches the hand-written kernel (``csrc/bucket_probe.cu``), a CPU tensor
runs the plain version ``probe_append_ref``.

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
from .ref import INVALID, probe_append_ref

__all__ = ["probe_append", "blockify_entries", "INVALID", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("bucket_probe", "probe_append_launch", [_P] * 9 + [_I] * 7 + [_P])

_MAX_L = 4096     # 3 * L int32 of the kernel's shared memory within 48 KB
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


def probe_append(cnt, head, qfp, active_q, ids_blocks, fps_blocks, *,
                 block_objs: int, max_chain: int, S: int, sbuf: int):
    """One radius of the fused probe for every query of a batch.

    cnt/head/qfp [Q, L] int32 (bucket sizes, chain-head rows, query
    fingerprints), active_q [Q] bool, ids/fps_blocks [NB, BLKp] int32.
    Chunk c < max_chain of bucket (q, l) is row head + c, readable iff
    active_q[q] and cnt > c * block_objs; step c is read iff fewer than S
    candidates were collected before it, and then all its readable rows
    are. Returns (buf_id [Q, sbuf] int32: the read steps' fingerprint
    matches in (step, l, slot) order, the first S of them, INVALID after;
    count [Q] int32, min(matches, S); blocks_read [Q] int32, the readable
    rows of the read steps).
    """
    Q, L = cnt.shape
    if head.shape != (Q, L) or qfp.shape != (Q, L) or active_q.shape != (Q,) \
            or fps_blocks.shape != ids_blocks.shape or ids_blocks.dim() != 2:
        raise ValueError(f"probe_append: shapes disagree: cnt {tuple(cnt.shape)}, head "
                         f"{tuple(head.shape)}, qfp {tuple(qfp.shape)}, active_q "
                         f"{tuple(active_q.shape)}, ids {tuple(ids_blocks.shape)}, "
                         f"fps {tuple(fps_blocks.shape)}")
    if max_chain < 1 or block_objs < 1 or not 0 < S <= sbuf:
        raise ValueError(f"probe_append: need max_chain >= 1, block_objs >= 1 and "
                         f"0 < S <= sbuf, got max_chain={max_chain} "
                         f"block_objs={block_objs} S={S} sbuf={sbuf}")
    kw = dict(block_objs=block_objs, max_chain=max_chain, S=S, sbuf=sbuf)
    if not use_kernel(cnt, head, qfp, active_q, ids_blocks, fps_blocks):
        return probe_append_ref(cnt, head, qfp, active_q, ids_blocks, fps_blocks, **kw)
    for name, t, nd in (("cnt", cnt, 2), ("head", head, 2), ("qfp", qfp, 2),
                        ("ids_blocks", ids_blocks, 2), ("fps_blocks", fps_blocks, 2)):
        check_operand("probe_append", name, t, torch.int32, nd)
    check_operand("probe_append", "active_q", active_q, torch.bool, 1)
    blkp = ids_blocks.shape[1]
    if blkp % 4 or ids_blocks.data_ptr() % 16 or fps_blocks.data_ptr() % 16:
        raise ValueError(f"probe_append: rows must be whole 16 B vectors "
                         f"(BLKp={blkp} must be a multiple of 4, 16 B-aligned)")
    if L > _MAX_L:
        raise ValueError(f"probe_append: the kernel stages a query's tables in "
                         f"shared memory and takes L <= {_MAX_L}, got L = {L}")
    dev = ids_blocks.device
    buf_id = torch.empty((Q, sbuf), dtype=torch.int32, device=dev)
    counts = torch.empty((2, Q), dtype=torch.int32, device=dev)
    if Q:
        with torch.cuda.device(dev):
            KERNEL(cnt.data_ptr(), head.data_ptr(), qfp.data_ptr(), active_q.data_ptr(),
                   ids_blocks.data_ptr(), fps_blocks.data_ptr(), buf_id.data_ptr(),
                   counts[0].data_ptr(), counts[1].data_ptr(), Q, L, max_chain,
                   block_objs, S, sbuf, blkp, torch.cuda.current_stream(dev).cuda_stream)
    return buf_id, counts[0], counts[1]
