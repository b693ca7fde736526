"""Plain PyTorch version of the bucket_probe kernel."""
from __future__ import annotations

import torch

__all__ = ["bucket_probe_ref", "INVALID"]

INVALID = 2**31 - 1


def bucket_probe_ref(block_rows, qfp, ids_blocks, fps_blocks):
    """block_rows [G], qfp [G], ids/fps_blocks [NB, BLKp] int32
    -> [G, BLKp] int32: matching ids, INVALID elsewhere."""
    rows = block_rows.to(torch.int64)
    ids = ids_blocks[rows]
    fps = fps_blocks[rows]
    match = (fps == qfp.to(fps.dtype)[:, None]) & (ids != INVALID)
    return torch.where(match, ids, INVALID)
