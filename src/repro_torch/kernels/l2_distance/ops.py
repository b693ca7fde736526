"""l2_distance wrappers: a CUDA tensor launches the hand-written kernel, a
CPU tensor runs the plain version.

* ``l2_distance_gathered`` (``csrc/l2_distance.cu``): the query plans'
  distance epilogue over a gathered candidate buffer;
* ``l2_distance`` (``csrc/l2_distance_dense.cu``): the dense clamped
  distance grid of the exact k-NN scan. Unlike the reference's wrapper it
  neither pads to 128 nor picks TPU tiles (the kernel bounds-checks ragged
  shapes) and keeps no small-shape shortcut to the plain version."""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import l2_distance_gathered_ref, l2_distance_ref

__all__ = ["l2_distance", "l2_distance_gathered", "KERNEL", "DENSE_KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("l2_distance", "l2_gathered_launch", [_P] * 5 + [_I] * 4 + [_P])
DENSE_KERNEL = CudaKernel("l2_distance_dense", "l2_dense_launch", [_P] * 3 + [_I] * 3 + [_P])


def l2_distance(q, x):
    """q [NQ, D], x [NC, D] -> d2 [NQ, NC] float32 = max(qn2 + xn2 - 2 q.x, 0),
    the norms computed in the kernel. float16 inputs are cast to float32
    first, as the reference's wrapper does."""
    if q.dtype == torch.float16:
        q = q.to(torch.float32)
    if x.dtype == torch.float16:
        x = x.to(torch.float32)
    if not use_kernel(q, x):
        return l2_distance_ref(q, x)
    check_operand("l2_distance", "q", q, torch.float32, 2)
    check_operand("l2_distance", "x", x, torch.float32, 2)
    (NQ, D), (NC, Dx) = q.shape, x.shape
    if D != Dx:
        raise ValueError(f"l2_distance: q {tuple(q.shape)} and x {tuple(x.shape)} "
                         "differ in D")
    out = torch.empty((NQ, NC), dtype=torch.float32, device=x.device)
    if NQ and NC:
        with torch.cuda.device(x.device):
            DENSE_KERNEL(q.data_ptr(), x.data_ptr(), out.data_ptr(), NQ, NC, D,
                         torch.cuda.current_stream(x.device).cuda_stream)
    return out


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
