"""Random Fourier features: the wrapper of ``csrc/rff.cu``.

Z = sqrt(2/D) cos(X W^T + b) for a batch of rows.  Replaces
``repro/kernels/rff.py::rff_pallas``; it serves every RFF featurization
off the engine's fused round: the serving buckets (``predict_batch``),
``predict_one`` and the stacked ``predict``.

The wrapper checks device, dtype, shape and contiguity, allocates Z
with ``torch.empty``, launches on the current stream and counts the
launch (``_build.LAUNCH_COUNTS["rff"]``).  A CPU tensor goes to the
plain version (``ref.rff_ref``); a CUDA tensor goes to the kernel, or
the wrapper raises.
"""
from __future__ import annotations

import math

import torch

from . import _build, ref


def rff(X, W, b, *, num_features=None) -> torch.Tensor:
    """X (M, d), W (D, d), b (D,) -> Z (M, D) fp32; the scale is
    ``math.sqrt(2 / num_features)`` (default D), a host float."""
    if X.dim() != 2 or W.dim() != 2 or W.shape[1] != X.shape[1] \
            or b.shape != (W.shape[0],):
        raise ValueError(f"rff shapes X {tuple(X.shape)}, W "
                         f"{tuple(W.shape)}, b {tuple(b.shape)}")
    if X.device.type == "cpu":
        return ref.rff_ref(X, W, b, num_features=num_features)
    if X.device.type != "cuda":
        raise ValueError(f"rff: unsupported device {X.device}")
    _build.check_operands("rff", X.device, X=X, W=W, b=b)
    (M, d), D = X.shape, W.shape[0]
    Z = torch.empty((M, D), dtype=torch.float32, device=X.device)
    if M == 0 or D == 0:
        return Z
    scale = math.sqrt(2.0 / (num_features or D))
    _build.launch(
        "rff", "repro_rff", X.device,
        _build.ptr(X), _build.ptr(W), _build.ptr(b), _build.ptr(Z),
        M, D, d, float(scale), _build.stream_of(X))
    return Z
