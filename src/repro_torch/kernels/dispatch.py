"""Device policy for the PyTorch/CUDA port (counterpart of
``repro.kernels.dispatch``).

One rule, with no override: a CUDA tensor goes through the hand-written
kernel, a CPU tensor through the kernel's plain PyTorch version. Entry points
take ``device=None``, which means ``"cuda"``; on a machine without CUDA they
raise unless the caller asked for ``device="cpu"``, so a run never carries on
silently on the host. There is deliberately no environment variable or flag
that sends CUDA tensors to the plain version: it would hide the kernel.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "use_kernel", "check_operand", "native_lane_pad"]


def _pin_fp32_matmul() -> None:
    """Keep every float32 matmul and convolution on the card in full IEEE
    float32. TF32 keeps ~10 mantissa bits, which moves a projection by
    ~1e-3 relative: enough to push ``floor((a.x + b) / wR)`` across a bucket
    boundary and flip the bucket. The plain path on the card (the oracle plan
    and the kernels' plain versions) must hash as the reference does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run the plain PyTorch "
                "versions of the kernels on the host")
        _pin_fp32_matmul()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on one CUDA device (launch the kernel),
    False when they all lie on the CPU (run the plain version)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}; expected cuda or cpu")


def check_operand(kernel: str, name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d tensor of ``dtype``: the
    CUDA entry points take raw pointers and trust the layout."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def native_lane_pad() -> int:
    """Block-store row-width alignment (``BLKp`` is ``block_objs`` rounded up
    to this). The reference pads to 128 for the TPU's lane width; on the card
    8 is enough: at ``block_objs`` = 99, BLKp = 104, so each row of
    ``ids_blocks``/``fps_blocks`` is 416 B — a multiple of 16 B, so the
    probe kernel reads it with aligned ``int4`` loads — and the gather
    streams 5 dead lanes per row instead of 29. The CPU path uses the same
    layout, so both devices hold identical indexes."""
    return 8
