"""Fused per-round kernels: the wrappers of ``csrc/sv_predict.cu`` and
``csrc/primal_step.cu``.

- :func:`sv_predict` replaces ``repro/kernels/fused.py::sv_predict_pallas``:
  the SV family's predictions yhat_i = sum_j k(x_i, s_ij) a_ij, only
  the (B,) predictions leave the kernel.
- :func:`primal_step` replaces ``repro/kernels/fused.py::primal_step_pallas``:
  the RFF / linear families' whole round (featurize, predict, loss and
  gradient, update) in one launch.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and
counts the launch (``_build.LAUNCH_COUNTS``).  A CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor goes to the kernel, or
the wrapper raises.
"""
from __future__ import annotations

import torch

from . import _build, ref

KINDS = {"gaussian": 0, "linear": 1, "poly": 2}
LOSSES = {"hinge": 0, "squared": 1}


def sv_predict(X, SV, A, *, kind="gaussian", gamma=1.0, degree=3,
               coef0=1.0) -> torch.Tensor:
    """X (B, d), SV (B, N, d), A (B, N) -> (B,) fp32; padded slots must
    carry A = 0."""
    B, N, d = SV.shape
    if X.shape != (B, d) or A.shape != (B, N):
        raise ValueError(f"sv_predict shapes X {tuple(X.shape)}, SV "
                         f"{tuple(SV.shape)}, A {tuple(A.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if X.device.type == "cpu":
        return ref.sv_predict_ref(X, SV, A, kind=kind, gamma=gamma,
                                  degree=degree, coef0=coef0)
    if X.device.type != "cuda":
        raise ValueError(f"sv_predict: unsupported device {X.device}")
    _build.check_operands("sv_predict", X.device, X=X, SV=SV, A=A)
    out = torch.empty((B,), dtype=torch.float32, device=X.device)
    _build.launch(
        "sv_predict", "repro_sv_predict", X.device,
        _build.ptr(X), _build.ptr(SV), _build.ptr(A), _build.ptr(out),
        B, N, d, KINDS[kind], float(gamma), int(degree), float(coef0),
        _build.stream_of(X))
    return out


def primal_step(X, Yl, w, b, *, W=None, bias=None, scale=1.0,
                loss="hinge", eta=0.5, lam=0.01):
    """One fused round for B stacked primal learners: X (B, d), labels
    (B,), w (B, D), b (B,) [, W (D, d), bias (D,)] -> (w_new, b_new,
    ell, yhat).  Without ``W`` the features are z = x (D == d)."""
    B, d = X.shape
    D = w.shape[1] if w.dim() == 2 else -1
    featurize = W is not None
    if w.shape != (B, D) or Yl.shape != (B,) or b.shape != (B,):
        raise ValueError(f"primal_step shapes X {tuple(X.shape)}, y "
                         f"{tuple(Yl.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}")
    if featurize:
        if bias is None or W.shape != (D, d) or bias.shape != (D,):
            raise ValueError("primal_step: W must be (D, d) and bias (D,)")
    elif D != d:
        raise ValueError(f"primal_step: linear step needs D == d, got {D}, {d}")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    if X.device.type == "cpu":
        return ref.primal_step_ref(X, Yl, w, b, W=W, bias=bias, scale=scale,
                                   loss=loss, eta=eta, lam=lam)
    if X.device.type != "cuda":
        raise ValueError(f"primal_step: unsupported device {X.device}")
    operands = dict(X=X, Yl=Yl, w=w, b=b)
    if featurize:
        operands.update(W=W, bias=bias)
    _build.check_operands("primal_step", X.device, **operands)
    dev = X.device
    w_new = torch.empty((B, D), dtype=torch.float32, device=dev)
    b_new = torch.empty((B,), dtype=torch.float32, device=dev)
    ell = torch.empty((B,), dtype=torch.float32, device=dev)
    yhat = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "rff_step" if featurize else "linear_step", "repro_primal_step", dev,
        _build.ptr(X), _build.ptr(Yl), _build.ptr(w), _build.ptr(b),
        _build.ptr(W), _build.ptr(bias), _build.ptr(w_new),
        _build.ptr(b_new), _build.ptr(ell), _build.ptr(yhat),
        B, d, D, int(featurize), float(scale), LOSSES[loss], float(eta),
        float(1.0 - eta * lam), _build.stream_of(X))
    return w_new, b_new, ell, yhat
