"""lsh_hash wrapper: a CUDA tensor launches the hand-written kernel
(``csrc/lsh_hash.cu``), a CPU tensor runs the plain version (``ref.py``).

``lsh_hash_all_radii`` hashes the whole radius schedule in one launch (the
fused query plan's Step 1): [r, L, m] hash functions flatten into r*L*m
projection columns, each carrying its own width w*R.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel
from ..dispatch import check_operand, use_kernel
from .ref import lsh_hash_all_radii_ref

__all__ = ["lsh_hash_all_radii", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("lsh_hash", "lsh_hash_launch", [_P] * 7 + [_I] * 6 + [_P])


@functools.lru_cache(maxsize=16)
def _column_widths(device: torch.device, widths: tuple, per: int) -> torch.Tensor:
    """Per-column float32 width w*R: block t of `per` columns gets widths[t]."""
    w = torch.tensor(widths, dtype=torch.float32)
    return w.repeat_interleave(per).to(device)


def lsh_hash_all_radii(x, a, b, rm, *, w: float, radii, u: int, fp_bits: int):
    """Hash points under the full radius schedule in one launch.

    x [N, D] f32; a [r, L, m, D] f32; b [r, L, m] in [0, 1); rm [r, L, m]
    int32 (uint32 bit patterns); radii = the schedule.
    Returns (bucket, fp) [r, N, L] int32, the layout of stacking the
    per-radius results.
    """
    if not use_kernel(x, a, b, rm):
        return lsh_hash_all_radii_ref(x, a, b, rm, w=w, radii=radii, u=u,
                                      fp_bits=fp_bits)
    for name, t, dtype, nd in (("x", x, torch.float32, 2), ("a", a, torch.float32, 4),
                               ("rm", rm, torch.int32, 3)):
        check_operand("lsh_hash", name, t, dtype, nd)
    N, D = x.shape
    r, L, m, _ = a.shape
    if a.shape[3] != D or b.shape != (r, L, m) or rm.shape != (r, L, m) or len(radii) != r:
        raise ValueError(f"lsh_hash: shapes disagree: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, rm {tuple(rm.shape)}, "
                         f"{len(radii)} radii")
    if not (0 < u < 32 and 0 <= fp_bits < 32 and u + fp_bits <= 32):
        raise ValueError(f"lsh_hash: need 0 < u < 32 and u + fp_bits <= 32, "
                         f"got u={u} fp_bits={fp_bits}")
    # per-column width: radius t owns columns [t*L*m, (t+1)*L*m); the shift is
    # pre-multiplied, b * (w*R) in f32, as the reference's ops.py packs it
    wr = _column_widths(x.device, tuple(float(w) * float(rad) for rad in radii), L * m)
    bwr = (b.reshape(-1).to(torch.float32) * wr).contiguous()
    n_hashes = r * L
    bucket = torch.empty((N, n_hashes), dtype=torch.int32, device=x.device)
    fp = torch.empty((N, n_hashes), dtype=torch.int32, device=x.device)
    if N:
        with torch.cuda.device(x.device):
            KERNEL(x.data_ptr(), a.data_ptr(), bwr.data_ptr(), wr.data_ptr(),
                   rm.data_ptr(), bucket.data_ptr(), fp.data_ptr(),
                   N, D, n_hashes, m, u, fp_bits,
                   torch.cuda.current_stream(x.device).cuda_stream)
    # [N, r*L] -> [r, N, L]: columns are (t, l) ordered
    return bucket.view(N, r, L).permute(1, 0, 2), fp.view(N, r, L).permute(1, 0, 2)
