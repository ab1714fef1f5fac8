"""The kernel face the substrates call (port of ``repro/kernels/ops.py``).

- ``engages``: the one launch threshold every op shares — a call takes
  the kernel branch when any blocked extent reaches 128, the
  reference's ``_MIN_PALLAS`` (``repro/kernels/ops.py:50``), with the
  same operands at every call site.  Below it the ops return the plain
  expressions, exactly as the JAX package does: a shape rule that
  keeps small-model ``backend="kernels"`` runs identical to
  ``backend="reference"`` and the byte ledger backend-independent.
- ``LAUNCH_COUNTS``: launches per kernel name; a wrapper adds one only
  where its CUDA kernel runs (never on the CPU plain path).
- ``block_*`` keywords, as the reference's: each names the port's
  launch geometry on that axis (the docstrings say which).  ``None``
  resolves through ``autotune.tuned_blocks`` with the reference's
  ``kind`` strings; a value the kernel cannot take raises
  ``ValueError``.

``spec`` arguments are duck-typed against ``core.rkhs.KernelSpec``
(kind / gamma / degree / coef0).
"""
from __future__ import annotations

import torch

from . import fused, gram as gram_mod, quadform as quadform_mod, ref, \
    rff as rff_mod
from ._build import LAUNCH_COUNTS

_MIN_KERNEL = 128    # below this, use the plain expressions

__all__ = ["LAUNCH_COUNTS", "engages", "reset_launch_counts", "gram",
           "sv_predict", "quadform", "rkhs_dist_sq", "rkhs_dist_sq_groups",
           "rkhs_dist_sq_each",
           "fused_primal_step",
           "rff_features", "gram_spec", "sv_predict_spec", "quadform_spec",
           "rkhs_dist_sq_spec", "rkhs_dist_sq_groups_spec",
           "rkhs_dist_sq_each_spec"]


def engages(*dims) -> bool:
    """True when these operand extents take the kernel branch."""
    return max(int(d) for d in dims) >= _MIN_KERNEL


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _kw(spec) -> dict:
    return dict(kind=spec.kind, gamma=spec.gamma, degree=spec.degree,
                coef0=spec.coef0)


def gram(X, Y, *, kind="gaussian", gamma=1.0, degree=3, coef0=1.0,
         block_m=None, block_n=None, force_kernel=False):
    """K(X, Y): (M, d), (N, d) -> (M, N) fp32.  Engages on (M, N) like
    the reference's; inputs of another float dtype are widened first, as
    the reference's kernel does.  ``block_m`` / ``block_n``: the rows /
    columns of K a tile (compiled in: 128 / 128)."""
    M, N = X.shape[0], Y.shape[0]
    if not force_kernel and not engages(M, N):
        return ref.gram_ref(X, Y, kind=kind, gamma=gamma, degree=degree,
                            coef0=coef0)
    return gram_mod.gram(X.float().contiguous(), Y.float().contiguous(),
                         kind=kind, gamma=gamma, degree=degree, coef0=coef0,
                         block_m=block_m, block_n=block_n)


def sv_predict(X, SV, A, *, kind="gaussian", gamma=1.0, degree=3,
               coef0=1.0, block_n=None, force_kernel=False):
    """Fused batched SV predictions: X (B, d), SV (B, N, d), A (B, N) ->
    (B,).  Engagement depends on the budget N only, never on B.
    ``block_n``: the budget slots a block of a row's cluster owns (its
    chunk; at most 8 blocks a row)."""
    N = SV.shape[1]
    if not force_kernel and not engages(N):
        return ref.sv_predict_ref(X, SV, A, kind=kind, gamma=gamma,
                                  degree=degree, coef0=coef0)
    return fused.sv_predict(X.contiguous(), SV.contiguous(), A.contiguous(),
                            kind=kind, gamma=gamma, degree=degree,
                            coef0=coef0, block_n=block_n)


def quadform(X, Y, alpha, beta, *, kind="gaussian", gamma=1.0, degree=3,
             coef0=1.0, block_m=None, block_n=None, force_kernel=False):
    """P forms alpha_p^T K(X_p, Y_p) beta_p: (P, M, d), (P, N, d),
    (P, M), (P, N) -> (P,), without materializing K on the kernel path.
    ``block_m`` / ``block_n``: the rows of X_p / columns of Y_p a tile
    (compiled in: 64 / 128)."""
    if not force_kernel and not engages(X.shape[1], Y.shape[1]):
        return ref.quadform_ref(X, Y, alpha, beta, kind=kind, gamma=gamma,
                                degree=degree, coef0=coef0)
    return quadform_mod.quadform(
        X.contiguous(), Y.contiguous(), alpha.contiguous(),
        beta.contiguous(), kind=kind, gamma=gamma, degree=degree,
        coef0=coef0, block_m=block_m, block_n=block_n)


def rkhs_dist_sq(F, G, af, ag, *, kind="gaussian", gamma=1.0, degree=3,
                 coef0=1.0):
    """||f_i - g||_H^2 for m stacked models F (m, M, d) with masked
    coefficients af (m, M) against one model G (N, d), ag (N,):
    <f,f> + <g,g> - 2<f,g>, as the reference's ``ops.rkhs_dist_sq``
    vmapped over the learners with G unbatched computes it: m forms
    <f_i, f_i>, ONE form <g, g> and m forms <f_i, g>.  When all of them
    engage with one shape (budget == sync budget) they run as one launch
    of P = 2m + 1 forms; otherwise each group engages on its own
    operands.  A form's value does not depend on the forms beside it, so
    <g, g> once is bitwise each of the m copies a 3m-form launch
    computes; it is broadcast to the learners before the sum, which
    keeps the sum's order."""
    return rkhs_dist_sq_groups(F[None], G[None], af[None], ag[None],
                               kind=kind, gamma=gamma, degree=degree,
                               coef0=coef0)[0]


def rkhs_dist_sq_groups(F, G, af, ag, *, kind="gaussian", gamma=1.0,
                        degree=3, coef0=1.0):
    """``rkhs_dist_sq`` of g groups at once, each its own m models
    against its own G: F (g, m, M, d), G (g, N, d), af (g, m, M),
    ag (g, N) -> (g, m).  Group k's forms are ``rkhs_dist_sq``'s 2m + 1
    in its order, and the groups follow each other in one launch (or,
    off the one-launch case, in each group of forms' launch): a form's
    value depends on its own operands alone, so each group's distances
    are bitwise its own call's (the sweep's dynamic checks)."""
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    g, m, M, d = F.shape
    N = G.shape[1]
    Ff = F.reshape(g * m, M, d)
    aff = af.reshape(g * m, M)
    Gm = G[:, None].expand(g, m, N, d).reshape(g * m, N, d)
    agm = ag[:, None].expand(g, m, N).reshape(g * m, N)
    if M == N and engages(M):
        X = torch.cat([torch.cat([F[k], G[k:k + 1], F[k]]) for k in range(g)])
        Y = torch.cat([torch.cat([F[k], G[k:k + 1],
                                  G[k].expand(m, N, d)]) for k in range(g)])
        a = torch.cat([torch.cat([af[k], ag[k:k + 1], af[k]])
                       for k in range(g)])
        b = torch.cat([torch.cat([af[k], ag[k:k + 1], ag[k].expand(m, N)])
                       for k in range(g)])
        q = quadform(X, Y, a, b, **kw).reshape(g, 2 * m + 1)
        qff, qgg, qfg = q[:, :m], q[:, m:m + 1], q[:, m + 1:]
    else:
        qff = quadform(Ff, Ff, aff, aff, **kw).reshape(g, m)
        qgg = quadform(G, G, ag, ag, **kw).reshape(g, 1)
        qfg = quadform(Ff, Gm, aff, agm, **kw).reshape(g, m)
    return qff + qgg.expand(g, m) - 2.0 * qfg


def rkhs_dist_sq_each(F, G, af, ag, *, kind="gaussian", gamma=1.0,
                      degree=3, coef0=1.0):
    """||f_i - g_i||_H^2 for m stacked models F (m, M, d), af (m, M)
    against m stacked references G (m, N, d), ag (m, N): m forms
    <f_i, f_i>, m forms <g_i, g_i> and m forms <f_i, g_i> — one launch
    of P = 3m forms when they engage with one shape (M == N), otherwise
    each group of forms on its own operands.  A form's value depends on
    its own operands alone, so with every G_i equal to one G this is
    ``rkhs_dist_sq(F, G, ...)`` bitwise."""
    kw = dict(kind=kind, gamma=gamma, degree=degree, coef0=coef0)
    m, M = af.shape
    if M == ag.shape[1] and engages(M):
        q = quadform(torch.cat([F, G, F]), torch.cat([F, G, G]),
                     torch.cat([af, ag, af]), torch.cat([af, ag, ag]),
                     **kw).reshape(3, m)
        qff, qgg, qfg = q[0], q[1], q[2]
    else:
        qff = quadform(F, F, af, af, **kw)
        qgg = quadform(G, G, ag, ag, **kw)
        qfg = quadform(F, G, af, ag, **kw)
    return qff + qgg - 2.0 * qfg


def fused_primal_step(X, Yl, w, b, *, W=None, bias=None, scale=1.0,
                      loss="hinge", eta=0.5, lam=0.01, block_m=None,
                      force_kernel=False):
    """One fused online round for B stacked primal learners ->
    (w_new, b_new, ell, yhat); with ``W``/``bias`` the RFF map runs
    inside the kernel, otherwise z = x (the linear family).
    ``block_m``: RFF, the features a block of a learner's cluster owns
    (its chunk, at most 8 blocks); linear, the lane stride of a
    learner's warp (32 only)."""
    B, D = X.shape[0], w.shape[1]
    if not force_kernel and not engages(B, D):
        return ref.primal_step_ref(X, Yl, w, b, W=W, bias=bias, scale=scale,
                                   loss=loss, eta=eta, lam=lam)
    c = lambda t: None if t is None else t.contiguous()    # noqa: E731
    return fused.primal_step(c(X), c(Yl), c(w), c(b), W=c(W), bias=c(bias),
                             scale=scale, loss=loss, eta=eta, lam=lam,
                             block_m=block_m)


def rff_features(X, W, b, *, num_features=None, block_m=None, block_d=None,
                 force_kernel=False):
    """phi(X) = sqrt(2/D) cos(X W^T + b): X (M, d), W (D, d), b (D,) ->
    (M, D) fp32, D = ``num_features`` or W's rows.  Engages on (M, D)
    like the reference's; below the threshold it is the plain version.
    ``block_m``: the rows of Z a block owns (8 R for R rows a thread:
    8, 16, 32 or 64); ``block_d``: its columns (32 only)."""
    M, D = X.shape[0], W.shape[0]
    if not force_kernel and not engages(M, D):
        return ref.rff_ref(X, W, b, num_features=num_features or D)
    return rff_mod.rff(X.contiguous(), W.contiguous(), b.contiguous(),
                       num_features=num_features or D, block_m=block_m,
                       block_d=block_d)


# ---------------------------------------------------------------------------
# KernelSpec-driven entry points (the substrates' kernels backend)
# ---------------------------------------------------------------------------


def gram_spec(spec, X, Y, **kw):
    return gram(X, Y, **_kw(spec), **kw)


def sv_predict_spec(spec, X, SV, A, **kw):
    return sv_predict(X, SV, A, **_kw(spec), **kw)


def quadform_spec(spec, X, Y, alpha, beta, **kw):
    return quadform(X, Y, alpha, beta, **_kw(spec), **kw)


def rkhs_dist_sq_spec(spec, F, G, af, ag):
    return rkhs_dist_sq(F, G, af, ag, **_kw(spec))


def rkhs_dist_sq_groups_spec(spec, F, G, af, ag):
    return rkhs_dist_sq_groups(F, G, af, ag, **_kw(spec))


def rkhs_dist_sq_each_spec(spec, F, G, af, ag):
    return rkhs_dist_sq_each(F, G, af, ag, **_kw(spec))
