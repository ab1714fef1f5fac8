"""Online learners (port of ``repro/core/learners.py``).

All updates are batched over leading axes: a stacked state of m
learners updates in one call where the reference vmaps the
per-learner update.  Implemented: kernel_sgd (NORMA), kernel_pa,
linear_sgd and linear_pa with the hinge or squared loss.

Support-vector ids are minted in int32 as
``counter * MAX_LEARNERS + learner_id``, value for value with the
reference, because the Sec. 3 byte ledger is a function of id sets.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .rkhs import (KernelSpec, SVModel, empty_model, insert_sv, int_pow,
                   predict, scale_model)

# A global cap on the number of learners used only to mint unique
# support-vector ids (id = counter * MAX_LEARNERS + learner_id).
MAX_LEARNERS = 4096

# The counter may not exceed this bound or the int32 id wraps negative
# and the slot reads as empty (repro/core/learners.py:52-64).
MAX_INSERTIONS_PER_LEARNER = (2**31 - 1) // MAX_LEARNERS


def check_id_capacity(num_rounds: int) -> None:
    """Refuse runs long enough to wrap the int32 sv_id space."""
    if num_rounds > MAX_INSERTIONS_PER_LEARNER:
        raise ValueError(
            f"{num_rounds} rounds can mint sv_ids past int32 "
            f"(counter * MAX_LEARNERS + learner_id wraps after "
            f"{MAX_INSERTIONS_PER_LEARNER} insertions per learner); "
            "shard the stream into shorter runs")


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Configuration of an online learner (same fields and defaults as
    the reference's)."""

    algo: str = "kernel_sgd"
    loss: str = "hinge"
    eta: float = 0.5
    lam: float = 0.01
    C: float = 1.0
    budget: int = 64
    evict: str = "smallest"
    kernel: KernelSpec = dataclasses.field(default_factory=KernelSpec)
    dim: int = 8

    def __post_init__(self):
        if self.algo not in ("kernel_sgd", "kernel_pa", "linear_sgd", "linear_pa"):
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.loss not in ("hinge", "squared"):
            raise ValueError(f"unknown loss {self.loss!r}")

    @property
    def is_kernel(self) -> bool:
        return self.algo.startswith("kernel")


class KernelLearnerState(NamedTuple):
    model: SVModel
    counter: torch.Tensor      # int32 — per-learner insertion counter
    learner_id: torch.Tensor   # int32 — index of this learner in [m]


class LinearLearnerState(NamedTuple):
    w: torch.Tensor            # (..., d)
    b: torch.Tensor            # (...)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def loss_and_grad(loss: str, yhat: torch.Tensor,
                  y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ell, dell/dyhat)."""
    if loss == "hinge":
        ell = torch.clamp(1.0 - y * yhat, min=0.0)
        g = torch.where(ell > 0.0, -y, torch.zeros_like(y))
        return ell, g
    r = yhat - y
    return 0.5 * r * r, r


# ---------------------------------------------------------------------------
# Kernel learners
# ---------------------------------------------------------------------------


def init_kernel_state(cfg: LearnerConfig, learner_id, *,
                      device=None) -> KernelLearnerState:
    """Blank state(s): ``learner_id`` an int or an int tensor of ids
    (its shape becomes the leading batch shape)."""
    lid = torch.as_tensor(learner_id, dtype=torch.int32, device=device)
    lead = tuple(lid.shape)
    return KernelLearnerState(
        model=empty_model(cfg.budget, cfg.dim, lead=lead, device=device),
        counter=torch.zeros(lead, dtype=torch.int32, device=device),
        learner_id=lid,
    )


def _kxx(cfg: LearnerConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.kernel.kind == "gaussian":
        return torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)
    xx = torch.sum(x * x, dim=-1)
    if cfg.kernel.kind == "linear":
        return xx
    return int_pow(xx + cfg.kernel.coef0, cfg.kernel.degree)


def kernel_update(cfg: LearnerConfig, state: KernelLearnerState,
                  example) -> Tuple[KernelLearnerState, torch.Tensor]:
    """One round of a (stacked) kernel learner."""
    x, _ = example
    yhat = predict(cfg.kernel, state.model, x[..., None, :])[..., 0]
    return kernel_update_from_yhat(cfg, state, example, yhat)


def kernel_update_from_yhat(cfg: LearnerConfig, state: KernelLearnerState,
                            example, yhat: torch.Tensor
                            ) -> Tuple[KernelLearnerState, torch.Tensor]:
    """``kernel_update`` with the prediction supplied by the caller (the
    fused scan round computes it once for the loss record and here)."""
    x, y = example
    f = state.model
    ell, g = loss_and_grad(cfg.loss, yhat, y)

    if cfg.algo == "kernel_sgd":
        f = scale_model(f, 1.0 - cfg.eta * cfg.lam)
        alpha_new = -cfg.eta * g
    else:  # kernel_pa
        tau_pa = torch.clamp(ell / torch.clamp(_kxx(cfg, x), min=1e-12),
                             max=cfg.C)
        direction = y if cfg.loss == "hinge" else -torch.sign(yhat - y)
        alpha_new = tau_pa * direction

    new_id = state.counter * MAX_LEARNERS + state.learner_id
    do_insert = torch.abs(alpha_new) > 0.0

    f_ins = insert_sv(f, x, alpha_new, new_id, evict=cfg.evict)
    f2 = SVModel(
        sv=torch.where(do_insert[..., None, None], f_ins.sv, f.sv),
        alpha=torch.where(do_insert[..., None], f_ins.alpha, f.alpha),
        sv_id=torch.where(do_insert[..., None], f_ins.sv_id, f.sv_id),
    )
    new_state = KernelLearnerState(
        model=f2,
        counter=state.counter + do_insert.to(torch.int32),
        learner_id=state.learner_id,
    )
    return new_state, ell


# ---------------------------------------------------------------------------
# Linear learners (the paper's baselines)
# ---------------------------------------------------------------------------


def init_linear_state(cfg: LearnerConfig, *, lead: Tuple[int, ...] = (),
                      device=None) -> LinearLearnerState:
    return LinearLearnerState(
        w=torch.zeros(lead + (cfg.dim,), dtype=torch.float32, device=device),
        b=torch.zeros(lead, dtype=torch.float32, device=device))


def linear_update(cfg: LearnerConfig, state: LinearLearnerState,
                  example) -> Tuple[LinearLearnerState, torch.Tensor]:
    x, y = example
    # multiply + reduce, not a dot (the reference's layout-independent
    # prediction)
    yhat = torch.sum(state.w * x, dim=-1) + state.b
    ell, g = loss_and_grad(cfg.loss, yhat, y)

    if cfg.algo == "linear_sgd":
        w = (1.0 - cfg.eta * cfg.lam) * state.w - cfg.eta * g[..., None] * x
        b = state.b - cfg.eta * g
    else:  # linear_pa
        tau_pa = torch.clamp(
            ell / torch.clamp(torch.sum(x * x, dim=-1) + 1.0, min=1e-12),
            max=cfg.C)
        direction = y if cfg.loss == "hinge" else -torch.sign(yhat - y)
        w = state.w + (tau_pa * direction)[..., None] * x
        b = state.b + tau_pa * direction
    return LinearLearnerState(w=w, b=b), ell


# ---------------------------------------------------------------------------
# Uniform entry points (one learner, as the asynchronous runtime's nodes
# hold them; the updates above take unbatched states too)
# ---------------------------------------------------------------------------


def init_state(cfg: LearnerConfig, learner_id: int = 0, *, device=None):
    if cfg.is_kernel:
        return init_kernel_state(cfg, learner_id, device=device)
    return init_linear_state(cfg, device=device)


def update(cfg: LearnerConfig, state, example):
    if cfg.is_kernel:
        return kernel_update(cfg, state, example)
    return linear_update(cfg, state, example)


def gamma_of(cfg: LearnerConfig) -> float:
    """The loss-proportionality constant of Thm. 4's bound."""
    return cfg.eta if cfg.algo.endswith("sgd") else min(cfg.C, 1.0)
