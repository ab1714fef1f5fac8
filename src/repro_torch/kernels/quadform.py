"""Batched RKHS quadratic forms: the wrapper of ``csrc/quadform.cu``.

q_p = alpha_p^T K(X_p, Y_p) beta_p for P independent forms in one
launch, never materializing a Gram matrix.  Replaces
``repro/kernels/quadform.py::quadform_pallas``; the reference vmaps
that kernel over the learners, which is what one launch of P forms
computes here.

Its tiles are compile-time constants of csrc/quadform.cu (``TILE``:
``kTM`` rows of X_p by ``kTN`` columns of Y_p), the one geometry
``autotune`` resolves for op ``quadform``.

A CPU tensor goes to the plain version (``ref.quadform_ref``); a CUDA
tensor goes to the kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from . import _build, autotune, ref

#: Rows of X per block in pass 1 (``kTM`` in csrc/quadform.cu).
ROWS_PER_BLOCK = 64
#: (rows of X_p, columns of Y_p) a tile: kTM, kTN in csrc/quadform.cu
TILE = (ROWS_PER_BLOCK, 128)
KINDS = {"gaussian": 0, "linear": 1, "poly": 2}


def _check(dims, blocks) -> None:
    if tuple(blocks) != TILE:
        raise ValueError(f"quadform's tiles are compiled in: (block_m, "
                         f"block_n) = {TILE}, not {tuple(blocks)}")


autotune.register("quadform", default=lambda dims: TILE, check=_check)


def quadform(X, Y, alpha, beta, *, kind="gaussian", gamma=1.0, degree=3,
             coef0=1.0, block_m=None, block_n=None) -> torch.Tensor:
    """X (P, M, d), Y (P, N, d), alpha (P, M), beta (P, N) -> (P,) fp32.
    ``block_m`` / ``block_n``: the rows of X_p / columns of Y_p a tile
    (64 / 128 only); None resolves through
    ``autotune.tuned_blocks("quadform", (M, N))``."""
    P, M, d = X.shape
    if Y.dim() != 3 or Y.shape[0] != P or Y.shape[2] != d \
            or alpha.shape != (P, M) or beta.shape != (P, Y.shape[1]):
        raise ValueError(f"quadform shapes X {tuple(X.shape)}, Y "
                         f"{tuple(Y.shape)}, alpha {tuple(alpha.shape)}, "
                         f"beta {tuple(beta.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if block_m is None or block_n is None:
        autotune.tuned_blocks("quadform", (M, Y.shape[1]),
                              kind=f"{kind}:d={d}")
    else:
        _check((M, Y.shape[1]), (block_m, block_n))
    if X.device.type == "cpu":
        return ref.quadform_ref(X, Y, alpha, beta, kind=kind, gamma=gamma,
                                degree=degree, coef0=coef0)
    if X.device.type != "cuda":
        raise ValueError(f"quadform: unsupported device {X.device}")
    _build.check_operands("quadform", X.device, X=X, Y=Y, alpha=alpha,
                          beta=beta)
    if P > 65535:
        raise ValueError(f"quadform: {P} forms exceed the grid's y extent")
    N = Y.shape[1]
    if P == 0 or M == 0 or N == 0:       # empty sums
        return torch.zeros((P,), dtype=torch.float32, device=X.device)
    out = torch.empty((P,), dtype=torch.float32, device=X.device)
    R = -(-M // ROWS_PER_BLOCK)
    partial = torch.empty((P, R), dtype=torch.float32, device=X.device)
    _build.launch(
        "quadform", "repro_quadform", X.device,
        _build.ptr(X), _build.ptr(Y), _build.ptr(alpha), _build.ptr(beta),
        _build.ptr(partial), _build.ptr(out), P, M, N, d, KINDS[kind],
        float(gamma), int(degree), float(coef0), _build.stream_of(X))
    return out
