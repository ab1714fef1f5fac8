"""Plain PyTorch versions of the hand-written kernels (port of
``repro/kernels/ref.py``).

They define what each CUDA kernel must compute.  A kernel wrapper runs
its plain version when its tensors lie on the CPU (the CPU tests), and
``chip_smoke.py`` holds every kernel against its plain version on the
card.  Same formulas as the reference's oracles: matmul cross terms,
and per-row multiply + sum for the SV predictions and the RFF
projection (the two functions under the serving row contract).
``flash_ref`` is the test oracle of the reference's flash kernel
(tests/test_kernels_pallas.py): float32 einsum + softmax.
"""
from __future__ import annotations

import math

import torch

from ..core.rkhs import KernelSpec, gram


def _spec(kind, gamma, degree, coef0) -> KernelSpec:
    return KernelSpec(kind=kind, gamma=float(gamma), degree=int(degree),
                      coef0=float(coef0))


def gram_ref(X, Y, *, kind="gaussian", gamma=1.0, degree=3, coef0=1.0):
    """K(X, Y) with the matmul cross term: (..., M, d), (..., N, d)."""
    return gram(_spec(kind, gamma, degree, coef0), X, Y)


def sv_predict_ref(X, SV, A, *, kind="gaussian", gamma=1.0, degree=3,
                   coef0=1.0):
    """yhat_i = sum_j k(X_i, SV_ij) A_ij: X (B, d), SV (B, N, d),
    A (B, N) -> (B,).  Padded slots must carry A = 0."""
    k = gram_ref(X[:, None, :], SV, kind=kind, gamma=gamma, degree=degree,
                 coef0=coef0)[:, 0, :]                       # (B, N)
    return torch.sum(k * A.float(), dim=-1)


def rff_ref(X, W, b, *, num_features=None):
    """Random Fourier features sqrt(2/D) cos(X W^T + b): X (M, d),
    W (D, d), b (D,) -> (M, D), D = ``num_features`` or W's rows.  The
    scale is the host float ``math.sqrt(2 / D)``, as the kernel gets it.

    The projection is a multiply + last-axis sum, not ``X @ W.T``:
    PyTorch's CPU matmul can give a row other low bits when M changes,
    and the serving contract needs a bucket's row to equal the
    single-row call bitwise on this path too."""
    X = X.float()
    W = W.float()
    scale = math.sqrt(2.0 / (num_features or W.shape[0]))
    proj = torch.sum(X[:, None, :] * W[None, :, :], dim=-1)
    return scale * torch.cos(proj + b.float()[None, :])


def quadform_ref(X, Y, alpha, beta, *, kind="gaussian", gamma=1.0,
                 degree=3, coef0=1.0):
    """P independent forms alpha_p^T K(X_p, Y_p) beta_p: X (P, M, d),
    Y (P, N, d), alpha (P, M), beta (P, N) -> (P,)."""
    K = gram_ref(X, Y, kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    return (alpha.float()[:, None, :] @ K @ beta.float()[:, :, None])[:, 0, 0]


def split_bf16(x):
    """x in float32 -> (hi, mid, lo) in bf16, the three-part split that
    the tensor-core ``flash`` (tools/flash_tc/flash_wgmma.cu) runs on p
    (and on q, k, v in float32): hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid).  Their sum holds x's 24 bits; for a bf16
    value mid and lo are zero."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def flash_ref(q, k, v, *, scale=None, causal=True, window=0):
    """Attention over folded heads: q (BH, S, hd), k and v (BH, L, hd)
    -> (BH, S, hd) in q's dtype.  Scores and weights in float32; query i
    may see key j when j <= i (``causal``) and j > i - ``window``
    (``window > 0``); hidden scores are -1e30, as the reference's."""
    hd = q.shape[-1]
    scale = float(scale) if scale is not None else hd ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    S, L = s.shape[-2:]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(L, device=q.device)[None, :]
    mask = torch.ones((S, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def _loss_grad_ref(loss, yhat, y):
    if loss == "hinge":
        ell = torch.clamp(1.0 - y * yhat, min=0.0)
        return ell, torch.where(ell > 0.0, -y, torch.zeros_like(y))
    r = yhat - y
    return 0.5 * r * r, r


def primal_step_ref(X, Yl, w, b, *, W=None, bias=None, scale=1.0,
                    loss="hinge", eta=0.5, lam=0.01):
    """One online round for B stacked primal learners -> (w_new, b_new,
    ell, yhat); with ``W``/``bias`` the RFF map z = scale cos(X W^T +
    bias), else z = X (linear)."""
    X = X.float()
    Yl = Yl.float()
    w = w.float()
    b = b.float()
    if W is not None:
        z = scale * torch.cos(X @ W.float().T + bias.float()[None, :])
    else:
        z = X
    yhat = torch.sum(w * z, dim=-1) + b
    ell, g = _loss_grad_ref(loss, yhat, Yl)
    w_new = (1.0 - eta * lam) * w - eta * g[:, None] * z
    b_new = b - eta * g
    return w_new, b_new, ell, yhat
