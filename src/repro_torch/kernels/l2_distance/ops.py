"""l2_distance_gathered wrapper: a CUDA tensor launches the hand-written
kernel (``csrc/l2_distance.cu``), a CPU tensor runs the plain version.

The dense ``l2_distance`` of the reference (``l2_distance_pallas``) is not on
the query path and is not ported yet (ROADMAP, Queue 2)."""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import l2_distance_gathered_ref

__all__ = ["l2_distance_gathered", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("l2_distance", "l2_gathered_launch", [_P] * 5 + [_I] * 4 + [_P])


def l2_distance_gathered(q, coords, xn2, qn2):
    """q [Q, D], coords [Q, S, D], xn2 [Q, S], qn2 [Q] float32
    -> d2 [Q, S] = xn2 - 2<coords, q> + qn2, unclamped."""
    if not use_kernel(q, coords, xn2, qn2):
        return l2_distance_gathered_ref(q, coords, xn2, qn2)
    for name, t, nd in (("q", q, 2), ("coords", coords, 3), ("xn2", xn2, 2),
                        ("qn2", qn2, 1)):
        check_operand("l2_distance_gathered", name, t, torch.float32, nd)
    Q, S, D = coords.shape
    if q.shape != (Q, D) or xn2.shape != (Q, S) or qn2.shape != (Q,):
        raise ValueError(f"l2_distance_gathered: shapes disagree: q {tuple(q.shape)}, "
                         f"coords {tuple(coords.shape)}, xn2 {tuple(xn2.shape)}, "
                         f"qn2 {tuple(qn2.shape)}")
    vec4 = int(D % 4 == 0 and q.data_ptr() % 16 == 0 and coords.data_ptr() % 16 == 0)
    out = torch.empty((Q, S), dtype=torch.float32, device=coords.device)
    if Q and S:
        with torch.cuda.device(coords.device):
            KERNEL(q.data_ptr(), coords.data_ptr(), xn2.data_ptr(), qn2.data_ptr(),
                   out.data_ptr(), Q, S, D, vec4,
                   torch.cuda.current_stream(coords.device).cuda_stream)
    return out
