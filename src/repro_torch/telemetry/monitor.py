"""Live loss-proportionality monitor (port of
``repro/telemetry/monitor.py``, DESIGN.md Sec. 11).

The paper's central quality claim (Def. 1, criterion.py) is that the
dynamic protocol keeps communication *loss-proportional*:

    adaptive  iff  C_Pi(T, m) in O(m * L_A(mT)).

``core.criterion.audit`` checks that post-hoc, once, at the end of a
run.  This module makes the criterion a *running* check: a
:class:`CriterionMonitor` consumes per-round (summed loss, bytes)
increments — from ``engine.run`` / ``engine.sweep`` outputs, the async
harness, or the serving engine, for any substrate and either topology
— and tracks the cumulative series

    bound(t) = slack * m * unit_bytes * max(L(t), loss_floor)

flagging ``violation_round``, the first round where cumulative bytes
outgrow the bound.  ``unit_bytes`` is the worst-case Sec. 3 cost of
ONE synchronization (:func:`unit_bytes_of` derives it from any
substrate for either topology), so the bound is the finite-run face of
the Thm. 7 inequality: a protocol that only syncs when loss justifies
it cannot spend more than O(1) syncs per unit of loss.

Exactness contract: the monitor's cumulative byte series is built from
the same per-round byte column the ``DeviceLedger`` produced, so it is
integer-exact against ``SimResult.cumulative_bytes`` for the port's
``engine.run`` / ``engine.sweep``, the asynchronous harness's
``AsyncSimResult`` and ``ServeResult.sim`` (tests/test_torch_monitor.py
holds it against the JAX package's monitor on the same runs).  Losses
are carried bitwise from the source series; the monitor never
recomputes them.

The monitor lives entirely on the host, after a run: it adds nothing
to the engine's rounds.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core import accounting
from ..core.simulation import SimResult
from ..core.substrate import SVSubstrate, substrate_of
from .trace import PID_MONITOR, Tracer


def unit_bytes_of(learner, m: int, topology: str = "coordinator") -> int:
    """Worst-case Sec. 3 bytes of ONE synchronization of ``m`` learners
    — the per-sync unit the adaptivity bound prices loss in.

    ``learner`` is anything ``substrate_of`` resolves.  For
    ``topology="allreduce"`` this is the substrate's own host-side
    constant (``Substrate.allreduce_sync_bytes``).  For the coordinator
    topology: primal substrates (RFF / linear) have the fixed
    ``2 m |theta| B`` cost of ``accounting.sync_bytes_linear``; the SV
    substrate's cost is data-dependent, so the unit is its worst case —
    every learner uploads a full budget-tau expansion of ids novel to
    the coordinator (union m*tau), and downloads the whole union:

        m * (tau B_alpha + tau B_x)                  uploads
      + m * (m tau B_alpha) + m (m-1) tau B_x        downloads
    """
    sub = substrate_of(learner)
    if topology == "allreduce":
        return int(sub.allreduce_sync_bytes(m))
    if topology != "coordinator":
        raise ValueError(f"unknown topology {topology!r}")
    if isinstance(sub, SVSubstrate):
        bm = accounting.ByteModel(dim=sub.input_dim)
        tau = int(sub.lcfg.budget)
        up = m * tau * (bm.B_alpha + bm.B_x)
        down = m * m * tau * bm.B_alpha + m * (m - 1) * tau * bm.B_x
        return up + down
    return int(accounting.sync_bytes_linear(sub.num_params, m))


@dataclasses.dataclass
class MonitorSeries:
    """The monitor's cumulative tracks, one entry per observed round."""

    cumulative_loss: np.ndarray    # (T,) float64, bitwise from source
    cumulative_bytes: np.ndarray   # (T,) int64, integer-exact vs ledger
    bound: np.ndarray              # (T,) float64 allowed bytes
    ratio: np.ndarray              # (T,) bytes / bound
    violation_round: Optional[int]

    @property
    def ok(self) -> bool:
        return self.violation_round is None

    def __len__(self) -> int:
        return len(self.cumulative_loss)


class CriterionMonitor:
    """Running check of loss-proportional communication.

    Feed per-round increments with :meth:`observe` (the async harness
    and serving engine do this as rounds complete) or whole result
    series with :meth:`observe_result`.  ``slack`` absorbs the
    constant of the O(.) statement; ``loss_floor`` keeps the bound
    positive through the first rounds, where an immediate sync (one
    unit) must not count as a violation of a still-zero loss.
    """

    def __init__(self, m: int, unit_bytes: int, *,
                 slack: float = 2.0, loss_floor: float = 1.0):
        if m < 1:
            raise ValueError(f"need m >= 1, got {m}")
        if unit_bytes <= 0:
            raise ValueError(f"unit_bytes must be > 0, got {unit_bytes}")
        if slack <= 0 or loss_floor <= 0:
            raise ValueError("slack and loss_floor must be > 0")
        self.m = int(m)
        self.unit_bytes = int(unit_bytes)
        self.slack = float(slack)
        self.loss_floor = float(loss_floor)
        self._cum_loss = 0.0
        self._cum_bytes = 0
        self._loss: List[float] = []
        self._bytes: List[int] = []
        self._bound: List[float] = []
        self.violation_round: Optional[int] = None

    @classmethod
    def for_substrate(cls, learner, m: int, *,
                      topology: str = "coordinator",
                      **kw) -> "CriterionMonitor":
        """Monitor with the per-sync unit derived from the substrate
        (works for SV / RFF / linear and both topologies)."""
        return cls(m, unit_bytes_of(learner, m, topology), **kw)

    # -- feeding -------------------------------------------------------------

    def observe(self, loss_sum: float, nbytes: int) -> bool:
        """One protocol round: summed-over-learners loss + the round's
        Sec. 3 bytes.  Returns True while the bound holds; records the
        first violating round in ``violation_round``."""
        t = len(self._loss)
        self._cum_loss += float(loss_sum)
        self._cum_bytes += int(nbytes)
        bound = (self.slack * self.m * self.unit_bytes
                 * max(self._cum_loss, self.loss_floor))
        self._loss.append(self._cum_loss)
        self._bytes.append(self._cum_bytes)
        self._bound.append(bound)
        ok = self._cum_bytes <= bound
        if not ok and self.violation_round is None:
            self.violation_round = t
        return ok

    def observe_result(self, res: SimResult) -> "CriterionMonitor":
        """Feed a whole result's per-round series (any entry point:
        the engine, the async harness, or ``ServeResult.sim``).

        The cumulative series are adopted from the source bitwise /
        integer-exactly — never re-accumulated from increments, which
        would reintroduce float re-summation drift on the loss track.
        """
        if self.rounds:
            raise ValueError("observe_result needs a fresh monitor")
        self._loss = [float(v) for v in res.cumulative_loss]
        self._bytes = [int(v) for v in res.cumulative_bytes]
        self._cum_loss = self._loss[-1] if self._loss else 0.0
        self._cum_bytes = self._bytes[-1] if self._bytes else 0
        self._refresh_bounds()
        return self

    def _refresh_bounds(self) -> None:
        self._bound = [
            self.slack * self.m * self.unit_bytes
            * max(lo, self.loss_floor) for lo in self._loss]
        self.violation_round = None
        for t, (b, bd) in enumerate(zip(self._bytes, self._bound)):
            if b > bd:
                self.violation_round = t
                break

    # -- reading -------------------------------------------------------------

    @property
    def rounds(self) -> int:
        return len(self._loss)

    @property
    def ok(self) -> bool:
        return self.violation_round is None

    def series(self) -> MonitorSeries:
        bound = np.asarray(self._bound, np.float64)
        nbytes = np.asarray(self._bytes, np.int64)
        return MonitorSeries(
            cumulative_loss=np.asarray(self._loss, np.float64),
            cumulative_bytes=nbytes,
            bound=bound,
            # reprolint: allow[ACC01] Def. 1 ratio track is a float diagnostic; observe() compares exact ints
            ratio=nbytes / np.maximum(bound, 1e-12),
            violation_round=self.violation_round,
        )

    def emit(self, tracer: Tracer, *, name: str = "criterion") -> None:
        """Write the monitor's tracks into a trace: two counter tracks
        (bytes vs bound, cumulative loss) on round-index time, plus an
        instant at the violation round if there is one."""
        for t in range(self.rounds):
            tracer.counter(f"{name}/bytes", float(t),
                           {"cumulative": int(self._bytes[t]),
                            "bound": float(self._bound[t])},
                           pid=PID_MONITOR)
            tracer.counter(f"{name}/loss", float(t),
                           {"cumulative": float(self._loss[t])},
                           pid=PID_MONITOR)
        if self.violation_round is not None:
            t = self.violation_round
            tracer.instant(f"{name}/violation", float(t), pid=PID_MONITOR,
                           args={"round": t,
                                 "bytes": int(self._bytes[t]),
                                 "bound": float(self._bound[t])})


def monitor_result(res: SimResult, learner, m: int, *,
                   topology: str = "coordinator",
                   **kw) -> CriterionMonitor:
    """One-call monitor over a finished run (``engine.run``, the async
    harness's ``AsyncSimResult``, or ``ServeResult.sim``)."""
    mon = CriterionMonitor.for_substrate(learner, m, topology=topology, **kw)
    return mon.observe_result(res)


def monitor_sweep(sweep_result, learner, m: int, *,
                  topology: str = "coordinator",
                  **kw) -> Sequence[CriterionMonitor]:
    """Per-config monitors over an ``engine.sweep`` result (uses its
    ``__getitem__`` materialization, so the byte series are the same
    int64 ledger columns the SimResult view exposes)."""
    return [monitor_result(sweep_result[i], learner, m,
                           topology=topology, **kw)
            for i in range(len(sweep_result))]


def monitor_population(pres, learner, *,
                       topology: str = "coordinator",
                       **kw) -> CriterionMonitor:
    """Def. 1 monitor over a population run (DESIGN.md Sec. 15).

    ``pres`` is a ``population.sim.PopulationResult``.  Under partial
    participation only the sampled cohort communicates, so the bound is
    priced at the LARGEST cohort the run ever synchronized — ``m`` and
    ``unit_bytes`` both evaluate at ``max_t |cohort_t|``, not at
    ``m_total`` — and the byte series fed to the monitor is the device
    ledger's cohort-only column, integer-exact (the engine charges
    nothing for detached learners; tests/test_torch_population.py holds
    the column against the set-algebra oracle).  An idle population (every
    round empty) monitors trivially at cohort 1.
    """
    m_eff = max(1, int(np.max(pres.cohort_sizes)))
    # a 1-learner allreduce ring moves 0 bytes; the monitor needs a
    # positive unit, and such a run cannot communicate anyway
    unit = max(1, unit_bytes_of(learner, m_eff, topology))
    mon = CriterionMonitor(m_eff, unit, **kw)
    return mon.observe_result(pres.sim)
