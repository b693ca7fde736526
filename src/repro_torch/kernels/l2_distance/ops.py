"""l2_distance wrappers: a CUDA tensor launches the hand-written kernel, a
CPU tensor runs the plain version.

* ``l2_distance_by_id`` (``csrc/l2_distance.cu``): the query plans'
  distance epilogue over a candidate buffer of ids, the rows gathered in
  the kernel;
* ``l2_distance`` (``csrc/l2_distance_dense.cu``): the dense clamped
  distance grid of the exact k-NN scan. Unlike the reference's wrapper it
  neither pads to 128 nor picks TPU tiles (the kernel bounds-checks ragged
  shapes) and keeps no small-shape shortcut to the plain version."""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import l2_distance_by_id_ref, l2_distance_ref

__all__ = ["l2_distance", "l2_distance_by_id", "KERNEL", "DENSE_KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("l2_distance", "l2_by_id_launch", [_P] * 6 + [_I] * 5 + [_P])
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


def l2_distance_by_id(q, buf_id, db, db_norm2, qn2):
    """q [Q, D], buf_id [Q, S] int32 (ids into db, or INVALID), db [N, D],
    db_norm2 [N], qn2 [Q] float32 -> d2 [Q, S] float32: +inf on an INVALID
    slot, else max(db_norm2[id] - 2 <db[id], q> + qn2, 0). Each slot's value
    depends on its query and id only, not on its position, S or Q. buf_id's
    rows may be strided (a column slice of a wider array)."""
    Q, S = buf_id.shape
    if q.dim() != 2 or q.shape[0] != Q or db.dim() != 2 or db.shape[1] != q.shape[1] \
            or db_norm2.shape != db.shape[:1] or qn2.shape != (Q,):
        raise ValueError(f"l2_distance_by_id: shapes disagree: q {tuple(q.shape)}, buf_id "
                         f"{tuple(buf_id.shape)}, db {tuple(db.shape)}, db_norm2 "
                         f"{tuple(db_norm2.shape)}, qn2 {tuple(qn2.shape)}")
    if not use_kernel(q, buf_id, db, db_norm2, qn2):
        return l2_distance_by_id_ref(q, buf_id, db, db_norm2, qn2)
    for name, t, nd in (("q", q, 2), ("db", db, 2), ("db_norm2", db_norm2, 1),
                        ("qn2", qn2, 1)):
        check_operand("l2_distance_by_id", name, t, torch.float32, nd)
    if buf_id.dtype != torch.int32 or (S > 1 and buf_id.stride(1) != 1):
        raise ValueError(f"l2_distance_by_id: buf_id must be int32 with unit column "
                         f"stride, got {buf_id.dtype} strides {buf_id.stride()}")
    D = q.shape[1]
    vec4 = int(D % 4 == 0 and q.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0)
    out = torch.empty((Q, S), dtype=torch.float32, device=db.device)
    if Q and S:
        with torch.cuda.device(db.device):
            KERNEL(q.data_ptr(), buf_id.data_ptr(), db.data_ptr(), db_norm2.data_ptr(),
                   qn2.data_ptr(), out.data_ptr(), Q, S, buf_id.stride(0), D, vec4,
                   torch.cuda.current_stream(db.device).cuda_stream)
    return out
