"""Gram matrices: the wrapper of ``csrc/gram.cu``.

K(X, Y) for the gaussian, polynomial and linear kernels, each element
written once, the row norms computed in-tile.  Replaces
``repro/kernels/gram.py::gram_pallas``; reached through ``ops.gram`` /
``ops.gram_spec``, as in the reference, and under the kernels backend
by ``core/compression.py::project``, whose solve needs the Gram of a
sync's slots (the reference leaves that Gram to XLA; ``truncate`` needs
only one form of it and takes ``quadform``).

A CPU tensor goes to the plain version (``ref.gram_ref``); a CUDA
tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .quadform import KINDS


def gram(X, Y, *, kind="gaussian", gamma=1.0, degree=3,
         coef0=1.0) -> torch.Tensor:
    """X (M, d), Y (N, d) -> K (M, N) fp32."""
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"gram shapes X {tuple(X.shape)}, Y "
                         f"{tuple(Y.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if X.device.type == "cpu":
        return ref.gram_ref(X, Y, kind=kind, gamma=gamma, degree=degree,
                            coef0=coef0)
    if X.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {X.device}")
    _build.check_operands("gram", X.device, X=X, Y=Y)
    (M, d), N = X.shape, Y.shape[0]
    K = torch.empty((M, N), dtype=torch.float32, device=X.device)
    if M == 0 or N == 0:
        return K
    _build.launch(
        "gram", "repro_gram", X.device,
        _build.ptr(X), _build.ptr(Y), _build.ptr(K), M, N, d, KINDS[kind],
        float(gamma), int(degree), float(coef0), _build.stream_of(X))
    return K
