"""Device resolution and float32 precision flags.

Every entry point of the port takes ``device=``.  ``None`` means the
CUDA card: there is no silent CPU fallback, so a machine without CUDA
raises and the caller has to ask for ``device="cpu"`` explicitly (the
CPU tests do).

Precision: the reference computes in full float32.  On the card a
float32 matrix product may run in TF32 (about three decimal digits),
which is outside the parity tolerance for the gaussian kernel's
``xx + yy - 2<x, y>`` cancellation, so both TF32 switches are set off
whenever a device is resolved.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def set_precision_flags() -> None:
    """Full float32 for matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def precision_flags() -> dict:
    """The flags as they stand, for run reports."""
    matmul = torch.backends.cuda.matmul
    return {"cuda.matmul.allow_tf32": matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            # the LM's bf16 GEMMs (cuBLAS may reduce split-K partial sums
            # in bf16 while this is True, PyTorch's default)
            "cuda.matmul.allow_bf16_reduced_precision_reduction":
                matmul.allow_bf16_reduced_precision_reduction}


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and
    there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_precision_flags()
    return dev

