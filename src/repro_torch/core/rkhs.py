"""RKHS models in support-vector expansion (port of ``repro/core/rkhs.py``).

A model f(.) = sum_{x in S} alpha_x k(x, .) is stored with a fixed
budget of slots; inactive slots carry ``alpha = 0`` and ``sv_id = -1``.
Ids are int32 everywhere, as in the reference: the Sec. 3 byte ledger
is a function of id sets, so the set algebra below
(``sorted_unique`` / ``count_members``) must give the reference's
integers exactly.

Every function here takes tensors with optional leading batch axes
(the learner axis m): where the reference vmaps a per-learner
function, the port writes the batch axis out.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

#: Padding value of the sorted-id set algebra (int32 max).
ID_SENTINEL = 2**31 - 1


# ---------------------------------------------------------------------------
# Kernel functions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """k : X x X -> R.  ``kind`` in {gaussian, linear, poly}."""

    kind: str = "gaussian"
    gamma: float = 1.0          # gaussian: exp(-gamma ||x-y||^2)
    degree: int = 3             # poly: (x.y + coef0)^degree
    coef0: float = 1.0

    def __post_init__(self):
        if self.kind not in ("gaussian", "linear", "poly"):
            raise ValueError(f"unknown kernel {self.kind!r}")


def int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a non-negative int n by repeated squaring, in the
    multiplication order of JAX's ``lax.integer_pow`` (``torch.pow``
    calls ``std::pow`` for n > 3, which rounds differently)."""
    if n < 0:
        raise ValueError(f"negative integer power {n}")
    acc: Optional[torch.Tensor] = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def gram(spec: KernelSpec, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Dense Gram matrix K[..., i, j] = k(X[..., i, :], Y[..., j, :]).

    The cross term is ``X @ Y^T``, as in the reference.  The gaussian
    branch updates ONE (M, N) buffer in place (``addmm_`` /
    ``baddbmm_``, ``clamp_``, ``mul_``, ``exp_``): at a full-width sync
    the truncation Gram is (m tau)^2 = 32768^2 floats, 4.3 GB, and the
    out-of-place expression would hold four of them.
    """
    X = X.float()
    Y = Y.float()
    Yt = Y.transpose(-1, -2)
    if spec.kind == "linear":
        return torch.matmul(X, Yt)
    if spec.kind == "poly":
        return int_pow(torch.matmul(X, Yt).add_(spec.coef0), spec.degree)
    xx = torch.sum(X * X, dim=-1)
    yy = torch.sum(Y * Y, dim=-1)
    K = xx[..., :, None] + yy[..., None, :]
    if K.dim() == 2:
        K.addmm_(X, Yt, alpha=-2.0)
    else:
        K.baddbmm_(X, Yt, alpha=-2.0)
    return K.clamp_(min=0.0).mul_(-spec.gamma).exp_()


def kernel_diag(spec: KernelSpec, X: torch.Tensor) -> torch.Tensor:
    """k(x, x) for each row, without the Gram's diagonal."""
    X = X.float()
    if spec.kind == "linear":
        return torch.sum(X * X, dim=-1)
    if spec.kind == "poly":
        return int_pow(torch.sum(X * X, dim=-1) + spec.coef0, spec.degree)
    return torch.ones(X.shape[0], dtype=torch.float32, device=X.device)


# ---------------------------------------------------------------------------
# Support-vector expansion with a fixed budget
# ---------------------------------------------------------------------------


class SVModel(NamedTuple):
    """A budgeted support-vector expansion (optionally stacked).

    sv:     (..., budget, d)  support vector inputs (zeros when inactive)
    alpha:  (..., budget)     coefficients (0 when inactive)
    sv_id:  (..., budget)     unique int32 id, -1 when the slot is empty
    """

    sv: torch.Tensor
    alpha: torch.Tensor
    sv_id: torch.Tensor

    @property
    def budget(self) -> int:
        return self.sv.shape[-2]

    @property
    def dim(self) -> int:
        return self.sv.shape[-1]


def empty_model(budget: int, dim: int, *, lead: Tuple[int, ...] = (),
                device=None) -> SVModel:
    """An all-inactive expansion, with optional leading batch axes."""
    return SVModel(
        sv=torch.zeros(lead + (budget, dim), dtype=torch.float32, device=device),
        alpha=torch.zeros(lead + (budget,), dtype=torch.float32, device=device),
        sv_id=torch.full(lead + (budget,), -1, dtype=torch.int32, device=device),
    )


def active_mask(f: SVModel) -> torch.Tensor:
    return f.sv_id >= 0


def num_active(f: SVModel) -> torch.Tensor:
    """The number of occupied slots (int32, batched over lead axes)."""
    return torch.sum(active_mask(f).to(torch.int32), dim=-1, dtype=torch.int32)


def masked_alpha(f: SVModel) -> torch.Tensor:
    """Coefficients with inactive slots zeroed."""
    return torch.where(active_mask(f), f.alpha, torch.zeros_like(f.alpha))


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v, dim=-1)


def _gram_rows(spec: KernelSpec, X: torch.Tensor, Y: torch.Tensor,
               sum_last=_sum_last) -> torch.Tensor:
    """``gram`` with the cross term as multiply + last-axis reduce, so a
    row's floats do not depend on how many rows share the call (the
    reference's prediction-path contract).  (..., n, d), (..., N, d)
    -> (..., n, N).  ``sum_last`` is the last-axis reduction."""
    X = X.float()
    Y = Y.float()
    cross = sum_last(X[..., :, None, :] * Y[..., None, :, :])
    if spec.kind == "linear":
        return cross
    if spec.kind == "poly":
        return int_pow(cross + spec.coef0, spec.degree)
    xx = sum_last(X * X)[..., :, None]
    yy = sum_last(Y * Y)[..., None, :]
    sq = torch.clamp(xx + yy - 2.0 * cross, min=0.0)
    return torch.exp(-spec.gamma * sq)


def predict(spec: KernelSpec, f: SVModel, X: torch.Tensor,
            sum_last=_sum_last) -> torch.Tensor:
    """f(X) = K(X, S) alpha with inactive slots masked: (..., n, d) ->
    (..., n), batched over the model's leading axes.  ``sum_last`` is
    every last-axis reduction (the serving face passes a fixed-order
    one)."""
    a = masked_alpha(f)
    return sum_last(_gram_rows(spec, X, f.sv, sum_last) * a[..., None, :])


def quadform(K: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T K b as row-wise multiply + last-axis sum, then one outer sum
    (the reference's layout-independent order); batched over leading
    axes."""
    return torch.sum(a * torch.sum(K * b[..., None, :], dim=-1), dim=-1)


def quadform_(K: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``quadform`` that overwrites K (``mul_``) instead of allocating
    a second (M, N) buffer — for the (m tau)^2 truncation Gram."""
    return torch.sum(a * torch.sum(K.mul_(b[..., None, :]), dim=-1), dim=-1)


def norm_sq(spec: KernelSpec, f: SVModel) -> torch.Tensor:
    """||f||_H^2 = alpha^T K(S, S) alpha."""
    a = masked_alpha(f)
    return quadform(gram(spec, f.sv, f.sv), a, a)


def dist_sq(spec: KernelSpec, f: SVModel, g: SVModel) -> torch.Tensor:
    """||f - g||_H^2 = <f,f> + <g,g> - 2<f,g> (paper Sec. 2); f and g
    share their leading axes."""
    af = masked_alpha(f)
    ag = masked_alpha(g)
    return (
        quadform(gram(spec, f.sv, f.sv), af, af)
        + quadform(gram(spec, g.sv, g.sv), ag, ag)
        - 2.0 * quadform(gram(spec, f.sv, g.sv), af, ag)
    )


def stacked_dist_to(spec: KernelSpec, stacked: SVModel, ref: SVModel) -> torch.Tensor:
    """Per-learner ||f_i - r||^2, shape (m,): the local conditions.
    The reference vmaps ``dist_sq(f_i, r)``; here r's own quadform is
    computed once and broadcast (the same value for every learner)."""
    m = stacked.sv.shape[0]
    af = masked_alpha(stacked)
    ag = masked_alpha(ref)
    g_sv = ref.sv.expand((m,) + tuple(ref.sv.shape))
    return (
        quadform(gram(spec, stacked.sv, stacked.sv), af, af)
        + quadform(gram(spec, ref.sv, ref.sv), ag, ag)
        - 2.0 * quadform(gram(spec, stacked.sv, g_sv), af,
                         ag.expand((m,) + tuple(ag.shape)))
    )


def divergence_stacked(spec: KernelSpec, stacked: SVModel) -> torch.Tensor:
    """delta(f) = 1/m sum_i ||f_i - fbar||^2 over RKHS models (Eq. 1)."""
    fbar = average_stacked(stacked)
    return torch.mean(stacked_dist_to(spec, stacked, fbar))


# ---------------------------------------------------------------------------
# Prop. 2: averaging a model configuration
# ---------------------------------------------------------------------------


def average_stacked(stacked: SVModel) -> SVModel:
    """Average of a stacked configuration (leading axis m) — Prop. 2:
    the concatenation of all slots with coefficients divided by m
    (budget m * tau)."""
    m, tau, d = stacked.sv.shape
    alpha = torch.where(stacked.sv_id >= 0, stacked.alpha / m,
                        torch.zeros_like(stacked.alpha))
    return SVModel(sv=stacked.sv.reshape(m * tau, d),
                   alpha=alpha.reshape(m * tau),
                   sv_id=stacked.sv_id.reshape(m * tau))


# ---------------------------------------------------------------------------
# Sorted-id set algebra (the Sec. 3 ledger's sets, fixed shapes)
# ---------------------------------------------------------------------------


def _sentinel_like(ids: torch.Tensor) -> torch.Tensor:
    return torch.full_like(ids, ID_SENTINEL)


def sorted_unique_rows(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sorted_unique`` along the last axis, batched over the others:
    (..., n) int32 -> (uniq (..., n), count (...,))."""
    active = (ids >= 0) & (ids < ID_SENTINEL)
    s = torch.sort(torch.where(active, ids, _sentinel_like(ids)), dim=-1).values
    first = torch.cat(
        [s[..., :1] < ID_SENTINEL,
         (s[..., 1:] != s[..., :-1]) & (s[..., 1:] < ID_SENTINEL)], dim=-1)
    uniq = torch.sort(torch.where(first, s, _sentinel_like(s)), dim=-1).values
    return uniq, torch.sum(first.to(torch.int32), dim=-1, dtype=torch.int32)


def sorted_unique(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted-distinct representation of an active id set (flattened):
    the distinct ids ``0 <= id < ID_SENTINEL`` ascending, padded with
    ID_SENTINEL, and their count."""
    return sorted_unique_rows(ids.reshape(-1))


def count_members(queries: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """|Q ∩ A| per row of sorted-unique queries (..., q) against one
    sorted id array A (n,); sentinel slots never count."""
    n = sorted_ids.shape[0]
    idx = torch.clamp(torch.searchsorted(sorted_ids, queries), 0, n - 1)
    hit = (sorted_ids[idx] == queries) & (queries < ID_SENTINEL)
    return torch.sum(hit.to(torch.int32), dim=-1, dtype=torch.int32)


def union_unique_count(ids: torch.Tensor) -> torch.Tensor:
    """|Sbar| — the number of distinct active support vector ids."""
    return sorted_unique(ids)[1]


# ---------------------------------------------------------------------------
# Slot insertion (shared by the online learners)
# ---------------------------------------------------------------------------


def insert_sv(f: SVModel, x: torch.Tensor, alpha_new: torch.Tensor,
              new_id: torch.Tensor, evict: str = "smallest") -> SVModel:
    """Insert a support vector into a budgeted expansion (batched over
    leading axes): a free slot if one exists, else the slot the
    eviction policy picks (``smallest`` |alpha| or ``oldest`` id).
    ``torch.argmin`` returns the FIRST minimum, as ``jnp.argmin`` does,
    so ties resolve to the reference's slot."""
    act = active_mask(f)
    neg_inf = torch.full_like(f.alpha, float("-inf"))
    if evict == "smallest":
        score = torch.where(act, torch.abs(f.alpha), neg_inf)
    elif evict == "oldest":
        score = torch.where(act, f.sv_id.to(torch.float32), neg_inf)
    else:
        raise ValueError(f"unknown eviction policy {evict!r}")
    slot = torch.argmin(score, dim=-1)
    hit = torch.arange(f.budget, device=f.sv.device) == slot[..., None]
    return SVModel(
        sv=torch.where(hit[..., None], x.float()[..., None, :], f.sv),
        alpha=torch.where(hit, alpha_new.float()[..., None], f.alpha),
        sv_id=torch.where(hit, new_id.to(torch.int32)[..., None], f.sv_id),
    )


def scale_model(f: SVModel, c) -> SVModel:
    """c * f  (coefficient scaling — e.g. the (1 - eta*lambda) decay)."""
    return f._replace(alpha=f.alpha * c)


def pad_to_budget(f: SVModel, tau: int) -> SVModel:
    """Pad (inactive fill) or truncate an expansion to budget tau."""
    n = f.sv.shape[-2]
    if n >= tau:
        return SVModel(sv=f.sv[..., :tau, :], alpha=f.alpha[..., :tau],
                       sv_id=f.sv_id[..., :tau])
    pad = empty_model(tau - n, f.sv.shape[-1], lead=tuple(f.sv.shape[:-2]),
                      device=f.sv.device)
    return SVModel(sv=torch.cat([f.sv, pad.sv], dim=-2),
                   alpha=torch.cat([f.alpha, pad.alpha], dim=-1),
                   sv_id=torch.cat([f.sv_id, pad.sv_id], dim=-1))
