"""Gram matrices: the wrapper of ``csrc/gram.cu``.

K(X, Y) for the gaussian, polynomial and linear kernels, each element
written once, the row norms computed in-tile.  Replaces
``repro/kernels/gram.py::gram_pallas``; reached through ``ops.gram`` /
``ops.gram_spec``, as in the reference, and under the kernels backend
by ``core/compression.py::project``, whose solve needs the Gram of a
sync's slots (the reference leaves that Gram to XLA; ``truncate`` needs
only one form of it and takes ``quadform``).

Its tiles are compile-time constants of csrc/gram.cu (``TILE``:
``kTM`` x ``kTN``), the one geometry ``autotune`` resolves for op
``gram``.

A CPU tensor goes to the plain version (``ref.gram_ref``); a CUDA
tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from . import _build, autotune, ref
from .quadform import KINDS


#: (rows, columns) of K a tile: kTM, kTN in csrc/gram.cu
TILE = (128, 128)


def _check(dims, blocks) -> None:
    if tuple(blocks) != TILE:
        raise ValueError(f"gram's tiles are compiled in: (block_m, block_n) "
                         f"= {TILE}, not {tuple(blocks)}")


autotune.register("gram", default=lambda dims: TILE, check=_check)


def gram(X, Y, *, kind="gaussian", gamma=1.0, degree=3, coef0=1.0,
         block_m=None, block_n=None) -> torch.Tensor:
    """X (M, d), Y (N, d) -> K (M, N) fp32.  ``block_m`` / ``block_n``:
    the rows / columns of K a tile (128 / 128 only); None resolves
    through ``autotune.tuned_blocks("gram", (M, N))``."""
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"gram shapes X {tuple(X.shape)}, Y "
                         f"{tuple(Y.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    dims = (X.shape[0], Y.shape[0])
    if block_m is None or block_n is None:
        autotune.tuned_blocks("gram", dims, kind=f"{kind}:d={X.shape[1]}")
    else:
        _check(dims, (block_m, block_n))
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
