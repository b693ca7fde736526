"""Plain PyTorch versions of the l2_distance kernels."""
from __future__ import annotations

import torch

from ..bucket_probe.ref import INVALID

__all__ = ["l2_distance_ref", "l2_distance_gathered_ref", "l2_distance_by_id_ref"]


def l2_distance_ref(q, x):
    """q [NQ, D], x [NC, D] -> d2 [NQ, NC] float32, clamped at 0: the dense
    distance the exact k-NN scan needs, in the reference's op order
    ``(qn2 + xn2) - 2 * dot``."""
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    dot = q @ x.T
    qn2 = (q * q).sum(dim=-1, keepdim=True)
    xn2 = (x * x).sum(dim=-1, keepdim=True).T
    return torch.clamp(qn2 + xn2 - 2.0 * dot, min=0.0)


def l2_distance_gathered_ref(q, coords, xn2, qn2):
    """Per-query gathered-candidate distances (the probe epilogue).

    q [Q, D], coords [Q, S, D] (candidate coordinates, already gathered),
    xn2 [Q, S] precomputed ||x||^2, qn2 [Q] -> d2 [Q, S] float32, unclamped
    (the caller masks invalid slots and clamps). The dot is a row-wise
    multiply-and-sum, so each slot's value depends on its own row only and
    not on the buffer width S: the oracle and fused plans, whose buffers
    differ in width, get bit-identical distances on the same device.
    """
    dot = (coords.to(torch.float32) * q.to(torch.float32)[:, None, :]).sum(-1)
    return xn2 - 2.0 * dot + qn2[:, None]


def l2_distance_by_id_ref(q, buf_id, db, db_norm2, qn2):
    """Step 3 of the plans over a candidate buffer of ids: the candidates'
    rows and norms gathered from the DRAM tier, ``l2_distance_gathered_ref``
    on them, clamped at 0 and +inf on INVALID slots.

    q [Q, D], buf_id [Q, S] int32, db [N, D], db_norm2 [N], qn2 [Q]
    -> d2 [Q, S] float32."""
    valid = buf_id != INVALID
    safe_id = torch.where(valid, buf_id, 0).to(torch.int64)
    d2 = l2_distance_gathered_ref(q, db[safe_id], db_norm2[safe_id], qn2)
    return torch.where(valid, torch.clamp(d2, min=0.0), torch.inf)
