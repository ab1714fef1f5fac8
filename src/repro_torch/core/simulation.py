"""Run results and the serial loop oracle (port of
``repro/core/simulation.py``).

``SimResult`` is what every driver returns; the engine builds it
through ``SimResult.from_round_series`` exactly as the reference's
engine does.

``run_kernel_simulation`` / ``run_linear_simulation`` are the
reference's serial drivers, the oracle the engine is held to: a Python
loop over T that predicts and updates the stacked learners, decides a
sync on the host, averages and compresses the union, and prices each
sync in the host ``accounting.CommunicationLedger``.  Like the
reference's (plain jitted JAX) they are plain PyTorch with no kernel
backend, on ``device`` (default the CUDA card; ``"cpu"`` for the
tests).  Losses and errors accumulate per round on the host in float64
from the device's float32 sums, as the reference's do; so the engine
equals the oracle in sync rounds, bytes and error counts, and in
losses, divergences and compression errors to float32 rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from . import accounting, compression, learners, rkhs
from .learners import LearnerConfig, LinearLearnerState
from .protocol import ProtocolConfig
from .rkhs import SVModel


@dataclasses.dataclass
class SimResult:
    """Everything the figure benchmarks need."""

    cumulative_loss: np.ndarray        # (T,) summed over learners
    cumulative_bytes: np.ndarray       # (T,)
    cumulative_errors: np.ndarray      # (T,) 0/1 prediction mistakes
    sync_rounds: np.ndarray            # indices where a sync happened
    divergences: np.ndarray            # (T,) measured delta(f_t)
    eps_history: np.ndarray            # compression errors at syncs
    num_syncs: int
    total_bytes: int
    total_loss: float

    @property
    def quiescence_round(self) -> Optional[int]:
        """First round from which the run is synchronization-free through
        the end: 0 without syncs, ``s + 1`` after a last sync at
        ``s < T - 1``, None when a sync landed on the final round."""
        if len(self.sync_rounds) == 0:
            return 0
        last = int(self.sync_rounds[-1])
        T = len(self.cumulative_loss)
        return last + 1 if last + 1 <= T - 1 else None

    @classmethod
    def from_round_series(
        cls,
        losses: np.ndarray,       # (T,) per-round summed loss
        errors: np.ndarray,       # (T,) per-round summed errors
        round_bytes: np.ndarray,  # (T,) bytes charged per round
        divergences: np.ndarray,  # (T,) or (0,) measured delta(f_t)
        sync_flags: np.ndarray,   # (T,) bool, True where a sync happened
        eps: np.ndarray,          # (T,) or (0,) compression error per round
    ) -> "SimResult":
        """Accumulate per-round series on the host in float64/int64."""
        losses = np.asarray(losses, np.float64)
        errors = np.asarray(errors, np.float64)
        sync_flags = np.asarray(sync_flags, bool)
        cum_bytes = np.cumsum(np.asarray(round_bytes, np.int64))
        cum_loss = np.cumsum(losses)
        return cls(
            cumulative_loss=cum_loss,
            cumulative_bytes=cum_bytes,
            cumulative_errors=np.cumsum(errors),
            sync_rounds=np.nonzero(sync_flags)[0].astype(np.int64),
            divergences=np.asarray(divergences, np.float64),
            eps_history=(np.asarray(eps, np.float64)[sync_flags]
                         if len(eps) else np.zeros((0,))),
            num_syncs=int(sync_flags.sum()),
            total_bytes=int(cum_bytes[-1]) if len(cum_bytes) else 0,
            total_loss=float(cum_loss[-1]) if len(cum_loss) else 0.0,
        )


# ---------------------------------------------------------------------------
# The serial loop oracle
# ---------------------------------------------------------------------------


def _stacked_init(lcfg: LearnerConfig, m: int, device):
    """m learners initialized one by one (learner i with id i), stacked."""
    states = [learners.init_state(lcfg, i, device=device) for i in range(m)]
    return _stack(states)


def _stack(trees):
    if torch.is_tensor(trees[0]):
        return torch.stack(trees)
    return type(trees[0])(*(_stack(list(leaves)) for leaves in zip(*trees)))


def _sync_now(pcfg: ProtocolConfig, t: int, dists) -> bool:
    """The host's sync decision; ``dists()`` computes the local
    distances on a dynamic check round only."""
    if pcfg.kind == "continuous":
        return True
    if pcfg.kind == "periodic":
        return (t + 1) % pcfg.period == 0
    if pcfg.kind == "dynamic" and (t + 1) % pcfg.mini_batch == 0:
        return bool((dists().cpu().numpy() > pcfg.delta).any())
    return False


def _service_error(loss: str, yhat: torch.Tensor, y: torch.Tensor) -> float:
    """The round's summed service error: mistakes for hinge (a zero
    margin predicts +1), squared error otherwise."""
    if loss == "hinge":
        pred = torch.where(yhat >= 0, 1.0, -1.0)
        return float(torch.sum(pred != y))
    return float(torch.sum((yhat - y) ** 2))


def run_kernel_simulation(
    lcfg: LearnerConfig,
    pcfg: ProtocolConfig,
    X: np.ndarray,          # (T, m, d) per-round per-learner inputs
    Y: np.ndarray,          # (T, m)
    sync_budget: Optional[int] = None,
    compress_method: str = compression.DEFAULT_METHOD,
    device=None,
) -> SimResult:
    """Run T rounds of m kernel learners under the given protocol.

    ``sync_budget``: budget of the synchronized (averaged) model that is
    shipped back to the learners; default the learner budget tau, so the
    union average (budget m tau) is compressed back to tau and the
    compression error feeds the epsilon term of Thm. 4.  ``device``
    (default the CUDA card): where the stacked models live.
    """
    dev = device_mod.resolve(device)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    assert d == lcfg.dim
    learners.check_id_capacity(T)
    tau = lcfg.budget
    sync_budget = sync_budget or tau
    spec = lcfg.kernel

    stacked = _stacked_init(lcfg, m, dev)

    def make_sync(models: SVModel):
        fbar = rkhs.average_stacked(models)          # budget m * tau
        return compression.compress(spec, fbar, sync_budget, compress_method)

    def set_all(fsync: SVModel) -> SVModel:
        # the learners adopt the (compressed) average, padded to tau
        one = rkhs.pad_to_budget(fsync, tau)
        return SVModel(*(v.expand((m,) + tuple(v.shape)).clone()
                         for v in one))

    # the reference model starts as the (empty) average
    reference, _ = make_sync(stacked.model)

    ledger = accounting.CommunicationLedger(accounting.ByteModel(dim=d))
    cum_loss, cum_bytes, cum_err, divs, eps_hist = [], [], [], [], []
    total_loss = 0.0
    total_err = 0.0
    Xd = torch.as_tensor(X, device=dev)
    Yd = torch.as_tensor(Y, device=dev)

    for t in range(T):
        xb, yb = Xd[t], Yd[t]
        # service quality before the update
        yhat = rkhs.predict(spec, stacked.model, xb[:, None, :])[:, 0]
        total_err += _service_error(lcfg.loss, yhat, yb)

        stacked, losses = learners.kernel_update(lcfg, stacked, (xb, yb))
        total_loss += float(torch.sum(losses))

        models = stacked.model
        if _sync_now(pcfg, t,
                     lambda: rkhs.stacked_dist_to(spec, models, reference)):
            ids = models.sv_id.cpu().numpy()
            fsync, eps = make_sync(models)
            eps_hist.append(float(eps))
            stacked = stacked._replace(model=set_all(fsync))
            reference = fsync
            ledger.record_kernel_sync([ids[i] for i in range(m)], t)
        else:
            ledger.record_no_sync()

        divs.append(float(rkhs.divergence_stacked(spec, stacked.model)))
        cum_loss.append(total_loss)
        cum_err.append(total_err)
        cum_bytes.append(ledger.total)

    return SimResult(
        cumulative_loss=np.asarray(cum_loss),
        cumulative_bytes=np.asarray(cum_bytes, dtype=np.int64),
        cumulative_errors=np.asarray(cum_err),
        sync_rounds=np.asarray(ledger.sync_rounds, dtype=np.int64),
        divergences=np.asarray(divs),
        eps_history=np.asarray(eps_hist),
        num_syncs=len(ledger.sync_rounds),
        total_bytes=int(ledger.total),
        total_loss=float(total_loss),
    )


def run_linear_simulation(
    lcfg: LearnerConfig,
    pcfg: ProtocolConfig,
    X: np.ndarray,
    Y: np.ndarray,
    device=None,
) -> SimResult:
    """Run T rounds of m linear learners (the paper's baseline
    hypothesis class) under the given protocol, on ``device``."""
    dev = device_mod.resolve(device)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    stacked = _stacked_init(lcfg, m, dev)

    def dists_to(st, ref):
        return torch.sum((st.w - ref.w) ** 2, dim=-1) + (st.b - ref.b) ** 2

    def diverg(st):
        wbar = torch.mean(st.w, dim=0)
        bbar = torch.mean(st.b)
        return torch.mean(torch.sum((st.w - wbar[None, :]) ** 2, dim=-1)
                          + (st.b - bbar) ** 2)

    def avg(st):
        return LinearLearnerState(w=torch.mean(st.w, dim=0),
                                  b=torch.mean(st.b))

    reference = avg(stacked)
    ledger = accounting.CommunicationLedger(accounting.ByteModel(dim=d))
    cum_loss, cum_bytes, cum_err, divs = [], [], [], []
    total_loss = 0.0
    total_err = 0.0
    nparams = d + 1
    Xd = torch.as_tensor(X, device=dev)
    Yd = torch.as_tensor(Y, device=dev)

    for t in range(T):
        xb, yb = Xd[t], Yd[t]
        # multiply + reduce, as the substrates predict
        yhat = torch.sum(stacked.w * xb, dim=-1) + stacked.b
        total_err += _service_error(lcfg.loss, yhat, yb)

        stacked, losses = learners.linear_update(lcfg, stacked, (xb, yb))
        total_loss += float(torch.sum(losses))

        if _sync_now(pcfg, t, lambda: dists_to(stacked, reference)):
            mean = avg(stacked)
            stacked = LinearLearnerState(w=mean.w.expand_as(stacked.w).clone(),
                                         b=mean.b.expand_as(stacked.b).clone())
            reference = mean
            ledger.record_linear_sync(nparams, m, t)
        else:
            ledger.record_no_sync()

        divs.append(float(diverg(stacked)))
        cum_loss.append(total_loss)
        cum_err.append(total_err)
        cum_bytes.append(ledger.total)

    return SimResult(
        cumulative_loss=np.asarray(cum_loss),
        cumulative_bytes=np.asarray(cum_bytes, dtype=np.int64),
        cumulative_errors=np.asarray(cum_err),
        sync_rounds=np.asarray(ledger.sync_rounds, dtype=np.int64),
        divergences=np.asarray(divs),
        eps_history=np.zeros((0,)),
        num_syncs=len(ledger.sync_rounds),
        total_bytes=int(ledger.total),
        total_loss=float(total_loss),
    )
