"""The paper's efficiency criterion (Definition 1) as measurable checks
(port of ``repro/core/criterion.py``: host numpy on a ``SimResult``, a
copy, since the port imports nothing of the JAX package).

Def. 1: a protocol Pi = (A, sigma) processing mT inputs is

  consistent  iff  L_Pi(T, m) in O(L_A(mT))          (serial loss kept)
  adaptive    iff  C_Pi(T, m) in O(m * L_A(mT))      (comm tied to loss)
  efficient   iff  consistent and adaptive.

Asymptotic statements cannot be *proved* from finite runs, but they can
be *audited*: we measure the ratios L_Pi / L_serial and
C_Pi / (m * L_serial * unit) on growing prefixes and check they stay
bounded (no upward trend).  We also verify the theorem-level inequalities
that imply the criterion:

  Thm. 4  :  L_D(T,m)  <=  L_P(T,m) + T (Delta + 2 eps^2) / gamma^2
  Prop. 6 :  V_D(T)    <=  (eta / sqrt(Delta)) * L_D(T, m)
  Thm. 7  :  C_D(T,m)  <=  V_D(T) * 2 m |Sbar_T| B_alpha + m |Sbar_T| B_x
  Prop. 5 :  C_C(T,m)  <=  2 T m |Sbar_T| B_alpha + m |Sbar_T| B_x

and the qualitative signature of efficiency: communication VANISHES
whenever the loss approaches zero (quiescence).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .accounting import ByteModel
from .simulation import SimResult


@dataclasses.dataclass
class CriterionReport:
    consistent_ratio: float        # L_Pi / L_serial   (bounded => consistent)
    adaptive_ratio: float          # C_Pi / (m L_Pi c_unit)
    sync_bound_ok: bool            # Prop. 6 inequality holds
    sync_bound_slack: float        # bound / measured (>= 1 when ok)
    comm_bound_ok: bool            # Thm. 7 inequality holds
    comm_bound_slack: float
    quiescent: bool                # no syncs in the final window
    ratios_trend: np.ndarray       # consistency ratio on growing prefixes


def check_sync_bound(
    res: SimResult, eta: float, delta: float
) -> tuple[bool, float]:
    """Prop. 6:  V_D(T) <= (eta / sqrt(Delta)) L_D(T, m)."""
    bound = (eta / np.sqrt(delta)) * res.total_loss
    v = max(res.num_syncs, 1e-12)
    return res.num_syncs <= bound + 1e-9, float(bound / v)


def check_comm_bound(
    res: SimResult,
    bm: ByteModel,
    m: int,
    union_size: int,
    eta: float,
    delta: float,
) -> tuple[bool, float]:
    """Thm. 7:  C_D <= (eta/sqrt(Delta)) L_D (2 m |Sbar_T| B_alpha)
                      + m |Sbar_T| B_x."""
    v_bound = (eta / np.sqrt(delta)) * res.total_loss
    bound = v_bound * 2 * m * union_size * bm.B_alpha + m * union_size * bm.B_x
    c = max(res.total_bytes, 1e-12)
    # integer bytes vs the (float) Thm. 7 bound, no epsilon slop: the
    # bound has orders-of-magnitude slack, a boundary tie is not real.
    return res.total_bytes <= bound, float(bound / c)


def check_continuous_comm_bound(
    total_bytes: int, bm: ByteModel, m: int, T: int, union_size: int
) -> bool:
    """Prop. 5:  C_C(T,m) <= 2 T m |Sbar_T| B_alpha + m |Sbar_T| B_x."""
    bound = 2 * T * m * union_size * bm.B_alpha + m * union_size * bm.B_x
    return total_bytes <= bound   # both sides int: exact, no slop


def quiescent(res: SimResult, window_frac: float = 0.2) -> bool:
    """True iff the run reached quiescence before the trailing window:
    no synchronization in rounds ``{w, ..., T-1}`` with
    ``w = ceil((1 - window_frac) * T)``.

    Defined through ``SimResult.quiescence_round`` so the two share
    one boundary convention: quiescent iff quiescence was observed
    (``quiescence_round is not None`` — a sync on the final round
    means it never was) and it arrived no later than the window start
    (``quiescence_round <= w``; a run with no syncs has
    ``quiescence_round == 0`` and is always quiescent).  Edge cases
    are pinned in tests/test_criterion.py."""
    T = len(res.cumulative_loss)
    w = int(np.ceil((1.0 - window_frac) * T))
    q = res.quiescence_round
    return q is not None and q <= w


def consistency_trend(res: SimResult, serial_cum_loss: np.ndarray) -> np.ndarray:
    """L_Pi(t) / L_serial(t') on growing prefixes.

    serial_cum_loss is the cumulative loss of the serial algorithm on
    the centralized stream of the same mT examples; prefix t of the
    distributed run corresponds to prefix m*t of the serial run.
    """
    T = len(res.cumulative_loss)
    m_ratio = len(serial_cum_loss) // T
    checkpoints = np.unique(np.linspace(max(T // 10, 1), T, 10).astype(int)) - 1
    out = []
    for t in checkpoints:
        s = serial_cum_loss[min((t + 1) * m_ratio - 1, len(serial_cum_loss) - 1)]
        out.append(res.cumulative_loss[t] / max(s, 1e-9))
    return np.asarray(out)


def audit(
    res: SimResult,
    serial_cum_loss: np.ndarray,
    bm: ByteModel,
    m: int,
    union_size: int,
    eta: float,
    delta: float,
) -> CriterionReport:
    trend = consistency_trend(res, serial_cum_loss)
    s_ok, s_slack = check_sync_bound(res, eta, delta)
    c_ok, c_slack = check_comm_bound(res, bm, m, union_size, eta, delta)
    c_unit = 2 * m * max(union_size, 1) * bm.B_alpha  # bytes per sync
    return CriterionReport(
        consistent_ratio=float(trend[-1]),
        # reprolint: allow[ACC01] Def. 1 ratio is a float diagnostic; the ledger itself stays int
        adaptive_ratio=float(res.total_bytes / max(m * res.total_loss * c_unit, 1e-9)),
        sync_bound_ok=s_ok,
        sync_bound_slack=s_slack,
        comm_bound_ok=c_ok,
        comm_bound_slack=c_slack,
        quiescent=quiescent(res),
        ratios_trend=trend,
    )
