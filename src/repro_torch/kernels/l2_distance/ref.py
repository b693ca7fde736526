"""Plain PyTorch version of the l2_distance_gathered kernel."""
from __future__ import annotations

import torch

__all__ = ["l2_distance_gathered_ref"]


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
