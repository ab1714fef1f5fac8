"""Discrete-event clock + deterministic seeded system models.

A copy of the reference's ``repro/runtime/clock.py`` (host-only,
numpy-seeded): the same event order, the same ``SeedSequence`` tags
and draw order, the same float arithmetic, so every simulated time a
serving run produces is equal to the reference's
(tests/test_torch_serving.py).  The port keeps its own copy because it
imports nothing of the JAX package.

Every action of a simulated run is an :class:`Event` on one priority
queue ordered by ``(time, seq)``; the monotonically increasing ``seq``
makes simultaneous events pop in scheduling order, so a run is a pure
function of its seeds.

:class:`SystemModel` owns all randomness of the simulated system:

- per-(round, learner) compute times with lognormal jitter and a
  deterministic straggler subset slowed by a multiplier;
- per-message latency = base * jitter + nbytes / bandwidth;
- i.i.d. message drops (link failures).

Compute times are drawn up front as a (T, m) table so the exact same
draws can price the synchronized-barrier baseline (sum_t max_i c[t,i])
against an asynchronous run (max_i sum_t c[t,i] + sync overhead).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    fn: Callable[[], None] = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(default=False, compare=False)


class Clock:
    """Global event queue.  ``schedule`` is the only way time advances.

    ``tracer`` (a ``telemetry.trace.Tracer``, optional) samples the
    queue as events process: a ``clock/queue`` counter track of
    pending events on the simulated timeline (DESIGN.md Sec. 11).
    Everything else traced in a run — message spans, round slices,
    sync episodes — is recorded by the component that owns it
    (transport / nodes / serving), all against this clock's ``now``,
    which is what makes the export deterministic under seed.
    """

    def __init__(self, tracer=None) -> None:
        self.now: float = 0.0
        self._seq: int = 0
        self._heap: List[Event] = []
        self.events_processed: int = 0
        self.tracer = tracer

    def schedule(self, delay: float, fn: Callable[[], None]) -> Event:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        ev = Event(self.now + delay, self._seq, fn)
        heapq.heappush(self._heap, ev)
        self._seq += 1
        return ev

    def schedule_at(self, time: float, fn: Callable[[], None]) -> Event:
        """Schedule at an *absolute* simulated time, preserved exactly.

        ``schedule(t - now, fn)`` round-trips the target through a
        subtraction and a re-addition, so a value that IS representable
        (a tick-grid point ``k * interval``, say) can come back a ulp
        off after ``now + (t - now)``.  Grid-sensitive callers (the
        serving tick scheduler) use this instead: the event fires at
        exactly the float passed in.  Times in the past are clamped to
        ``now`` (fire as soon as the queue reaches them).
        """
        ev = Event(max(self.now, float(time)), self._seq, fn)
        heapq.heappush(self._heap, ev)
        self._seq += 1
        return ev

    def cancel(self, ev: Event) -> None:
        """Mark a scheduled event dead: it is skipped when popped (the
        heap is not rebuilt), advances nothing, and is not counted in
        ``events_processed``.  Cancelling twice, or cancelling an event
        that already fired, is a no-op."""
        ev.cancelled = True

    def run(self, max_events: Optional[int] = None) -> None:
        """Process events until the queue drains (or max_events)."""
        n = 0
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            assert ev.time >= self.now, "event queue went backwards"
            self.now = ev.time
            ev.fn()
            self.events_processed += 1
            n += 1
            if self.tracer is not None:
                self.tracer.counter("clock/queue", self.now,
                                    {"pending": len(self._heap)})
            if max_events is not None and n >= max_events:
                return

    @property
    def pending(self) -> int:
        return len(self._heap)


# ---------------------------------------------------------------------------
# System models (latency / stragglers / failures)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Deterministic-under-seed model of the simulated cluster.

    All times are in abstract simulation units; ``base_compute = 1.0``
    means one learner round takes one unit on an unperturbed node.

    Attributes:
      seed: master seed for every draw the system makes.
      base_compute: mean per-round compute time of a healthy learner.
      compute_jitter: lognormal sigma of per-round compute noise
        (0 disables; mean is kept at base_compute by the -sigma^2/2
        correction).
      straggler_frac: fraction of learners designated stragglers.
      straggler_mult: compute-time multiplier applied to stragglers.
      straggler_prob: per-round probability that a designated straggler
        actually stalls by straggler_mult (1.0 = constantly slow;
        < 1 models intermittent stalls — GC pauses, preemption — where
        a lockstep barrier pays for every stall of every node while an
        async learner only pays for its own).
      base_latency: mean one-way message latency (0 = ideal network).
      latency_jitter: lognormal sigma of per-message latency noise.
      bandwidth: link bandwidth in bytes per time unit
        (``inf`` = size-independent latency).
      drop_prob: probability a message is silently lost in transit.
    """

    seed: int = 0
    base_compute: float = 1.0
    compute_jitter: float = 0.0
    straggler_frac: float = 0.0
    straggler_mult: float = 4.0
    straggler_prob: float = 1.0
    base_latency: float = 0.0
    latency_jitter: float = 0.0
    bandwidth: float = math.inf
    drop_prob: float = 0.0

    def __post_init__(self) -> None:
        if not (0.0 <= self.straggler_frac <= 1.0):
            raise ValueError("straggler_frac in [0, 1]")
        if not (0.0 < self.straggler_prob <= 1.0):
            raise ValueError("straggler_prob in (0, 1]")
        if self.bandwidth <= 0:
            raise ValueError("bandwidth must be > 0 (inf = unmetered)")
        if not (0.0 <= self.drop_prob < 1.0):
            raise ValueError("drop_prob in [0, 1)")
        if self.base_compute <= 0:
            raise ValueError("base_compute must be > 0")


class SystemModel:
    """Seeded sampler for compute times, latencies and drops.

    Two independent generators: compute draws are tabulated up front
    (shared with the barrier baseline), network draws happen on demand
    in event order (deterministic because event order is).
    """

    def __init__(self, cfg: SystemConfig, m: int):
        self.cfg = cfg
        self.m = m
        self._net_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0xA51C]))
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC0DE]))
        k = int(round(cfg.straggler_frac * m))
        self.stragglers = np.sort(rng.choice(m, size=k, replace=False)) \
            if k else np.zeros((0,), np.int64)
        self._compute_rng = rng

    def draw_compute(self, T: int) -> np.ndarray:
        """(T, m) per-round compute times; stragglers stall on a
        straggler_prob fraction of their rounds."""
        cfg = self.cfg
        mult = np.ones((T, self.m))
        if len(self.stragglers):
            stall = (self._compute_rng.random((T, len(self.stragglers)))
                     < cfg.straggler_prob)
            mult[:, self.stragglers] = np.where(stall, cfg.straggler_mult, 1.0)
        if cfg.compute_jitter > 0:
            z = self._compute_rng.normal(size=(T, self.m))
            jit = np.exp(cfg.compute_jitter * z - 0.5 * cfg.compute_jitter ** 2)
        else:
            jit = np.ones((T, self.m))
        return cfg.base_compute * mult * jit

    def draw_latency(self, nbytes: int) -> float:
        """One-way latency for a message of ``nbytes``."""
        cfg = self.cfg
        lat = cfg.base_latency
        if cfg.latency_jitter > 0 and lat > 0:
            z = self._net_rng.normal()
            lat *= math.exp(cfg.latency_jitter * z
                            - 0.5 * cfg.latency_jitter ** 2)
        if math.isfinite(cfg.bandwidth):
            # reprolint: allow[ACC01] bandwidth term: bytes->seconds in the time model, not ledger math
            lat += nbytes / cfg.bandwidth
        return lat

    def drop(self) -> bool:
        if self.cfg.drop_prob <= 0:
            return False
        return bool(self._net_rng.random() < self.cfg.drop_prob)

    def expected_round_trip(self) -> float:
        """Mean request+response latency, used by the barrier baseline
        to price one synchronization's network cost."""
        return 2.0 * self.cfg.base_latency


def barrier_wall_clock(compute_times: np.ndarray, num_syncs: int,
                       model: SystemModel, sync_bytes: int = 0) -> float:
    """Simulated wall-clock of the lockstep serial driver on the same
    cluster: every round ends with a global barrier (sum of per-round
    maxima), every synchronization adds a round trip to the
    coordinator, and ``sync_bytes`` of synchronization traffic pay the
    same bandwidth term the async runtime is charged per message."""
    per_round_max = compute_times.max(axis=1)
    total = float(per_round_max.sum()) + num_syncs * model.expected_round_trip()
    if math.isfinite(model.cfg.bandwidth):
        # reprolint: allow[ACC01] bandwidth term: bytes->seconds in the time model, not ledger math
        total += sync_bytes / model.cfg.bandwidth
    return total
