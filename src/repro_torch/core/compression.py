"""Model compression for support-vector expansions (port of
``repro/core/compression.py``).

- ``truncate``: keep the tau slots of largest |alpha| (Kivinen et al.);
  epsilon^2 = beta^T K_dd beta over the dropped part.
- ``project``: fold the dropped slots into the kept span by solving
  (K_kk + ridge I) c = K_kd beta; epsilon^2 is the projection residual.

Both return (compressed model with budget tau, epsilon) with the
reference's exact epsilon formulas.  Which slots are kept decides the
next sync's byte count, so both orderings use a STABLE sort, as the
reference's ``jnp.argsort`` is: ties among equal |alpha| (the
duplicated slots an average after an adopt produces) keep the
reference's slots.

Backends, as the substrates': ``"reference"`` evaluates the plain
expressions (the (M, M) Gram of the M = m tau slots of a sync's
average, 4.3 GB at M = 32768, then the form on it).  ``"kernels"``,
once M reaches the launch threshold (``ops.engages``), takes
``truncate``'s one form beta^T K beta through ``ops.quadform_spec``
(one form, P = 1, that never holds K in memory) and ``project``'s K,
which its solve needs, from ``ops.gram_spec``.  Which slots are kept
depends on |alpha| alone, so both backends compress to the same model;
epsilon moves by the order of its sums.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .rkhs import KernelSpec, SVModel, active_mask, gram, quadform, quadform_

#: The default compression method of every entry point.
DEFAULT_METHOD = "truncate"
BACKENDS = ("reference", "kernels")


def _kernels(backend: str, f: SVModel):
    """The kernel face (kernels.ops) when the kernels backend engages on
    f's slots, else None (the plain expressions)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "reference":
        return None
    from ..kernels import ops
    return ops if ops.engages(f.budget) else None


def _top_tau_mask(f: SVModel, tau: int) -> torch.Tensor:
    """Boolean mask of the tau active slots with the largest |alpha|."""
    act = active_mask(f)
    score = torch.where(act, torch.abs(f.alpha),
                        torch.full_like(f.alpha, float("-inf")))
    order = torch.argsort(-score, stable=True)   # descending, inactive last
    # a slot's rank is its position in ``order`` (the argsort of a
    # permutation is its inverse): sorts only, no scatter, so the mask
    # is the same under torch.use_deterministic_algorithms
    rank = torch.argsort(order)
    return (rank < tau) & act


def _pack_to_budget(f: SVModel, keep: torch.Tensor, tau: int) -> SVModel:
    """Gather the kept slots, in slot order, into a min(budget, tau)-slot
    model (the reference does not pad a smaller expansion either)."""
    # kept slots first (key 0), stable; the bool key is cast to an
    # integer type because sorting bools is not supported everywhere
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    idx = order[:tau]
    valid = keep[idx]
    return SVModel(
        sv=torch.where(valid[:, None], f.sv[idx], torch.zeros_like(f.sv[idx])),
        alpha=torch.where(valid, f.alpha[idx], torch.zeros_like(f.alpha[idx])),
        sv_id=torch.where(valid, f.sv_id[idx], torch.full_like(f.sv_id[idx], -1)),
    )


def truncate(spec: KernelSpec, f: SVModel, tau: int,
             backend: str = "reference") -> Tuple[SVModel, torch.Tensor]:
    """Truncate f to at most tau support vectors (smallest-|alpha| rule).
    Returns (f_trunc with budget tau, epsilon)."""
    keep = _top_tau_mask(f, tau)
    act = active_mask(f)
    dropped = act & ~keep
    beta = torch.where(dropped, f.alpha, torch.zeros_like(f.alpha))
    ops = _kernels(backend, f)
    if ops is not None:
        eps_sq = ops.quadform_spec(spec, f.sv[None], f.sv[None], beta[None],
                                   beta[None])[0]
    else:
        K = gram(spec, f.sv, f.sv)          # the one (M, M) buffer
        eps_sq = quadform_(K, beta, beta)
    eps_sq = torch.clamp(eps_sq, min=0.0)
    return _pack_to_budget(f, keep, tau), torch.sqrt(eps_sq)


def project(spec: KernelSpec, f: SVModel, tau: int, ridge: float = 1e-6,
            backend: str = "reference") -> Tuple[SVModel, torch.Tensor]:
    """Compress f to tau SVs by projecting dropped SVs on the kept span
    (float32 solve, as the reference's)."""
    keep = _top_tau_mask(f, tau)
    act = active_mask(f)
    dropped = act & ~keep
    beta = torch.where(dropped, f.alpha, torch.zeros_like(f.alpha))

    ops = _kernels(backend, f)
    K = (ops.gram_spec(spec, f.sv, f.sv) if ops is not None
         else gram(spec, f.sv, f.sv))
    keep_f = keep.to(K.dtype)
    K_kk = K * keep_f[:, None] * keep_f[None, :]
    K_kk = K_kk + (ridge + (1.0 - keep_f))[:, None] * torch.eye(
        f.budget, dtype=K.dtype, device=K.device)
    rhs = torch.sum(K * beta[None, :], dim=-1) * keep_f
    c = torch.linalg.solve(K_kk, rhs)
    c = c * keep_f

    eps_sq = quadform(K, beta, beta) - quadform(K, beta, c)
    eps_sq = torch.clamp(eps_sq, min=0.0)

    merged = f._replace(alpha=torch.where(keep, f.alpha + c, f.alpha))
    return _pack_to_budget(merged, keep, tau), torch.sqrt(eps_sq)


def compress(spec: KernelSpec, f: SVModel, tau: int,
             method: str = DEFAULT_METHOD,
             backend: str = "reference") -> Tuple[SVModel, torch.Tensor]:
    if method == "truncate":
        return truncate(spec, f, tau, backend=backend)
    if method == "project":
        return project(spec, f, tau, backend=backend)
    raise ValueError(f"unknown compression method {method!r}")


def truncation_error_bound(lam: float, tau: int) -> float:
    """The [12] bound epsilon in O((1/lam) (1-lam)^tau) for SGD with
    learning rate lam and budget tau."""
    return (1.0 / lam) * (1.0 - lam) ** tau
