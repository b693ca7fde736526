"""Plain PyTorch version of the fused probe kernel (``probe_append``) and
the pieces it is composed of."""
from __future__ import annotations

import torch

__all__ = ["append_candidates", "bucket_probe_ref", "probe_append_ref", "INVALID"]

INVALID = 2**31 - 1


def bucket_probe_ref(block_rows, qfp, ids_blocks, fps_blocks):
    """block_rows [G], qfp [G], ids/fps_blocks [NB, BLKp] int32
    -> [G, BLKp] int32: matching ids, INVALID elsewhere."""
    rows = block_rows.to(torch.int64)
    ids = ids_blocks[rows]
    fps = fps_blocks[rows]
    match = (fps == qfp.to(fps.dtype)[:, None]) & (ids != INVALID)
    return torch.where(match, ids, INVALID)


def append_candidates(buf_id, count, flat_id, flat_ok, S: int):
    """Compact-append fingerprint matches into the candidate buffer
    (truncated at S). Entries that do not fit go to one extra dump column
    that is sliced off: the scatter counterpart of the reference's
    ``mode="drop"``."""
    Q, sbuf = buf_id.shape
    ok = flat_ok.to(torch.int32)
    pos = count[:, None] + torch.cumsum(ok, dim=1, dtype=torch.int32) - ok
    keep = flat_ok & (pos < S)
    pos_w = torch.where(keep, pos, sbuf).to(torch.int64)
    wide = torch.cat([buf_id, buf_id.new_full((Q, 1), INVALID)], dim=1)
    wide.scatter_(1, pos_w, flat_id)
    count = torch.clamp(count + ok.sum(dim=1, dtype=torch.int32), max=S)
    return wide[:, :sbuf], count


def probe_append_ref(cnt, head, qfp, active_q, ids_blocks, fps_blocks, *,
                     block_objs: int, max_chain: int, S: int, sbuf: int):
    """One radius of the fused probe: every chain step's block rows read by
    one ``bucket_probe_ref`` gather, the oracle's per-step ``count < S``
    read gate replayed by a scan over chain depth, and the gated matches
    appended in (step, l, slot) order.

    cnt/head/qfp [Q, L] int32, active_q [Q] bool, ids/fps_blocks [NB, BLKp]
    int32 -> (buf_id [Q, sbuf] int32, INVALID past the count; count [Q];
    blocks_read [Q]) int32. Chunk c of bucket (q, l) is row head + c;
    chunks past the chain end and inactive queries read the empty spare
    row 0.
    """
    Q, L = cnt.shape
    C = max_chain
    BLKp = ids_blocks.shape[1]
    dev = cnt.device
    nonempty = (cnt > 0) & active_q[:, None]
    steps = torch.arange(C, device=dev, dtype=torch.int32)
    readable = nonempty[:, None, :] & (cnt[:, None, :] > steps[None, :, None] * block_objs)
    rows = torch.where(readable, head[:, None, :] + steps[None, :, None], 0)
    qfp_rep = qfp.to(torch.int32)[:, None, :].expand(Q, C, L)
    match = bucket_probe_ref(rows.reshape(-1), qfp_rep.reshape(-1), ids_blocks,
                             fps_blocks).view(Q, C, L * BLKp)
    hit = match != INVALID

    # chunks at depth c are read iff the count entering step c is below S
    # (count only grows)
    m_all = hit.sum(dim=2, dtype=torch.int32)                 # [Q, C]
    count = torch.zeros((Q,), dtype=torch.int32, device=dev)
    gates = []
    for c in range(C):
        gate = count < S
        gates.append(gate)
        count = torch.clamp(count + torch.where(gate, m_all[:, c], 0), max=S)
    step_active = torch.stack(gates, dim=1)                   # [Q, C]
    blocks_read = (readable & step_active[:, :, None]).sum(dim=(1, 2), dtype=torch.int32)

    buf_id = torch.full((Q, sbuf), INVALID, dtype=torch.int32, device=dev)
    flat_ok = hit & step_active[:, :, None]
    buf_id, count = append_candidates(
        buf_id, torch.zeros((Q,), dtype=torch.int32, device=dev),
        match.reshape(Q, C * L * BLKp), flat_ok.reshape(Q, C * L * BLKp), S)
    return buf_id, count, blocks_read
