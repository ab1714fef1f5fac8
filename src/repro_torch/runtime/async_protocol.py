"""Asynchronous synchronization policy (port of
``repro/runtime/async_protocol.py``, pure Python: a copy, since the
port imports nothing of the JAX package).

Asynchronous counterparts of the lockstep sigma_periodic /
sigma_dynamic.  The structural difference is *who decides when*:

- **async periodic**: every learner pushes its model after each b of
  its OWN rounds; no global round counter exists.
- **async dynamic**: a learner reports a local-condition violation
  ``||f_i - r||^2 > Delta`` the moment *it* observes one; the
  coordinator then pulls every learner once and aggregates whatever
  models have arrived when its aggregation window closes.  Stragglers
  join a later window instead of blocking this one.

Aggregation is staleness-weighted in the FedAsync style: a model based
on coordinator version ``tau`` merged at version ``t`` gets mixing
weight

    alpha_t = alpha * s(t - tau),   s in {constant, hinge, poly},

each arrived model k forms the candidate
``(1 - alpha_t^k) r + alpha_t^k f_k`` and the new reference is the
plain average of the candidates.  With ``alpha = 1`` and the constant
schedule the update is the paper's Prop. 2 average over the arrived
subset, which is why the zero-latency async run reproduces the
engine's ledger byte for byte.

The aggregation itself lives on the substrate
(``core.substrate.Substrate.aggregate``); this module owns only the
policy: the protocol configuration and the staleness schedules.
"""
from __future__ import annotations

import dataclasses


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AsyncProtocolConfig:
    """Configuration of the asynchronous protocol.

    Attributes:
      kind: ``periodic`` (push every ``period`` local rounds) or
        ``dynamic`` (violation-triggered, threshold ``delta``).
      period: local-round push period (periodic only).
      delta: divergence threshold Delta (dynamic only).
      mini_batch: local conditions are checked every ``mini_batch``
        local rounds (same role as in the serial protocol).
      alpha: base mixing weight of an arriving model.  ``1.0`` +
        constant schedule = plain averaging of the arrived subset.
      staleness: ``constant | hinge | poly`` — the s(.) schedule.
      stale_a / stale_b: schedule shape parameters (FedAsync: hinge is
        1 for lag <= b then 1/(a (lag - b)); poly is (lag+1)^-a).
      agg_window: how long (sim time) the coordinator collects arrived
        models after the first one before aggregating.  0 still batches
        all same-instant arrivals (event order is deterministic).
      control_bytes: metered size of control messages (violation
        reports / pull requests).  The paper's Sec. 3 accounting counts
        model payloads only, so this defaults to 0.
    """

    kind: str = "dynamic"
    period: int = 10
    delta: float = 0.1
    mini_batch: int = 1
    alpha: float = 1.0
    staleness: str = "constant"
    stale_a: float = 0.5
    stale_b: int = 4
    agg_window: float = 0.0
    control_bytes: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("periodic", "dynamic"):
            raise ValueError(f"unknown async protocol kind: {self.kind!r}")
        if self.staleness not in ("constant", "hinge", "poly"):
            raise ValueError(f"unknown staleness schedule: {self.staleness!r}")
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError("alpha in (0, 1]")
        if self.period < 1 or self.mini_batch < 1:
            raise ValueError("period and mini_batch must be >= 1")
        if self.staleness != "constant" and self.stale_a <= 0:
            raise ValueError("stale_a must be > 0 for hinge/poly schedules")
        if self.agg_window < 0:
            raise ValueError("agg_window must be >= 0")


def staleness_weight(cfg: AsyncProtocolConfig, lag: int) -> float:
    """s(t - tau), clipped to (0, 1]."""
    lag = max(int(lag), 0)
    if cfg.staleness == "constant":
        s = 1.0
    elif cfg.staleness == "hinge":
        s = 1.0 if lag <= cfg.stale_b else 1.0 / (cfg.stale_a * (lag - cfg.stale_b))
    else:  # poly
        s = float((lag + 1) ** (-cfg.stale_a))
    return min(max(s, 1e-12), 1.0)
