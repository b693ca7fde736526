"""The radius fold's wrapper: ``topk_merge`` folds one radius' candidates
into a query batch's search state. A CUDA state launches the hand-written
kernel (``csrc/topk_merge.cu``) and is updated in place; a CPU state runs the
plain version ``topk_merge_ref``."""
from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel
from ..dispatch import use_kernel
from .ref import topk_merge_ref

__all__ = ["topk_merge", "KERNEL", "MAX_ENTRIES"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("topk_merge", "topk_merge_launch",
                    [_P] * 9 + [_I, _P, _P, _I, _P, _I, _P] + [_I] * 7
                    + [ctypes.c_float, _P])

MAX_ENTRIES = 4096  # k + sbuf: a row's (id, d2) staged in 32 KB of shared memory
_STATE = (("best_id", torch.int32), ("best_d2", torch.float32), ("done", torch.bool),
          ("radii_searched", torch.int32), ("nio_table", torch.int32),
          ("nio_blocks", torch.int32), ("cands_checked", torch.int32),
          ("probe_sizes", torch.int32))


def _row_stride(name: str, x: torch.Tensor) -> int:
    """The stride between rows of a 2-d operand (or elements of a 1-d one)
    whose last dimension is dense, as the kernel reads it."""
    if x.dim() == 2 and x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"topk_merge: {name} must have unit column stride, got strides "
                         f"{x.stride()}")
    return x.stride(0)


def topk_merge(state, cand_id, cand_d2, cnt, blocks_read, count, *, t: int,
               thresh2: float):
    """Fold one radius' probe results into a batch's search state.

    state: (best_id [Q, k] int32, best_d2 [Q, k] float32, done [Q] bool,
    radii_searched, nio_table, nio_blocks, cands_checked [Q] int32,
    probe_sizes [Q, r, L] int32, or an empty tensor when the probe trace is
    not collected). cand_id [Q, sbuf] int32 and cand_d2 [Q, sbuf] float32:
    the radius' candidates (INVALID-padded) and their squared distances (+inf
    on INVALID); cnt [Q, L] int32: the radius' bucket sizes; blocks_read and
    count [Q] int32: the probe's block reads and candidates. t: the radius'
    position in the schedule; thresh2: (c R_t)^2 as a float32 value.

    A row not yet done merges its k entries and its candidates, in that
    order: an id seen earlier gets +inf, the k smallest by (d2, id, position)
    stay, ascending, INVALID where +inf; it is done when k of them lie within
    thresh2, counts one radius and its non-empty buckets, and records cnt (-1
    for empty buckets) as probe_sizes[:, t]. A done row keeps its top-k.
    Every row adds blocks_read and count.

    A CUDA state is updated IN PLACE by one launch on the current stream, no
    sync, and returned: the plans make a fresh state for every call, so no
    one else holds its tensors. A CPU state goes to ``topk_merge_ref``, which
    returns new tensors. cand_id and cnt may have strided rows and
    blocks_read and count strided elements (column slices of one upload, as
    the external plan passes). Raises where the kernel cannot take the shape
    (k + sbuf > 4096); never falls back for a CUDA tensor.
    """
    best_id, best_d2, done, radii, nio_t, nio_b, cands, probe_sizes = state
    Q, k = best_id.shape
    sbuf, L = cand_id.shape[1], cnt.shape[1]
    collect = probe_sizes.dim() == 3
    if best_d2.shape != (Q, k) or cand_id.shape[0] != Q or cand_d2.shape != (Q, sbuf) \
            or cnt.shape[0] != Q \
            or any(x.shape != (Q,) for x in (done, radii, nio_t, nio_b, cands,
                                              blocks_read, count)) \
            or (collect and (probe_sizes.shape[::2] != (Q, L)
                             or not 0 <= t < probe_sizes.shape[1])):
        raise ValueError(f"topk_merge: shapes disagree: best {tuple(best_id.shape)}, cand_id "
                         f"{tuple(cand_id.shape)}, cand_d2 {tuple(cand_d2.shape)}, cnt "
                         f"{tuple(cnt.shape)}, done {tuple(done.shape)}, probe_sizes "
                         f"{tuple(probe_sizes.shape)} at t = {t}")
    tensors = (*state, cand_id, cand_d2, cnt, blocks_read, count)
    if not use_kernel(*tensors):
        return topk_merge_ref(state, cand_id, cand_d2, cnt, blocks_read, count, t=t,
                              thresh2=thresh2)
    for (name, dtype), x in zip(_STATE, state):
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"topk_merge: state's {name} must be a contiguous {dtype} "
                             f"tensor, got {x.dtype} contiguous={x.is_contiguous()}")
    if cand_id.dtype != torch.int32 or cnt.dtype != torch.int32 \
            or blocks_read.dtype != torch.int32 or count.dtype != torch.int32 \
            or cand_d2.dtype != torch.float32 or not cand_d2.is_contiguous():
        raise ValueError("topk_merge: cand_id, cnt, blocks_read and count must be int32, "
                         "cand_d2 a contiguous float32 tensor")
    if k + sbuf > MAX_ENTRIES:
        raise ValueError(f"topk_merge: the kernel stages a row's k + sbuf entries in "
                         f"shared memory and takes k + sbuf <= {MAX_ENTRIES}, got "
                         f"k = {k}, sbuf = {sbuf}")
    if Q:
        args = (best_id.data_ptr(), best_d2.data_ptr(), done.data_ptr(), radii.data_ptr(),
                nio_t.data_ptr(), nio_b.data_ptr(), cands.data_ptr(),
                probe_sizes.data_ptr() if collect else None, cand_id.data_ptr(),
                _row_stride("cand_id", cand_id), cand_d2.data_ptr(), cnt.data_ptr(),
                _row_stride("cnt", cnt), blocks_read.data_ptr(), blocks_read.stride(0),
                count.data_ptr(), count.stride(0), Q, k, sbuf, L,
                probe_sizes.shape[1] if collect else 0, t, thresh2)
        # the current stream's raw handle, and the device guard only where
        # another device is current: the Stream object and the guard took 9
        # and 7 us of this call's 39 us of host time on an H100 machine
        index = best_id.get_device()
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index == torch.cuda.current_device():
            KERNEL(*args, stream)
        else:
            with torch.cuda.device(index):
                KERNEL(*args, stream)
    return state
