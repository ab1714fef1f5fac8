"""Slot scheduler, batch policies, admission control (port of
``repro/serving/scheduler.py``, host logic line for line).

The serving engine owns models and protocol rounds; a
:class:`SlotScheduler` owns WHEN predict batches launch, HOW BIG they
are, and WHAT happens when more requests arrive than the simulated
compute can carry.  No scheduler decision can reach the protocol
state, so the protocol view of a serving run is the engine's
(tests/test_torch_serving.py).  Every decision runs on the seeded
event clock, so the serving face (launch times, sheds, deferrals,
latencies) equals the reference's exactly.

Three pieces:

- :class:`SlotPool` — a fixed pool of in-flight *slots* (simulated
  predict lanes) per shard.  A launch occupies the earliest-free lane
  for ``predict_cost``.
- **batch policies** — :class:`TickScheduler` (requests wait for the
  next ``tick_interval`` grid point, then drain through the static
  bucket ladder) and :class:`ContinuousScheduler` (continuous
  batching: a request is admitted into a free slot on arrival; the
  launch size is ``min(queue_depth, buckets[-1])`` and an optional
  latency-budget hold timer coalesces under light load, never past
  ``oldest.arrival + max_wait``).
- **admission control** — a bounded pending queue (``max_queue``).
  Over capacity, the scheduler either **sheds** (the request is
  refused and never served) or **defers** (it retries admission
  ``defer_interval`` later; its latency keeps accruing from the
  ORIGINAL arrival).  Feedback is never admission-controlled.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..runtime.clock import Clock, Event
from ..telemetry.trace import PID_SERVING

__all__ = ["SlotPool", "SlotScheduler", "TickScheduler",
           "ContinuousScheduler", "make_scheduler", "POLICIES"]

POLICIES = ("tick", "continuous")


class SlotPool:
    """Fixed pool of simulated in-flight predict lanes for one shard.

    Purely bookkeeping on the simulated timeline: ``busy_until[i]`` is
    when lane i's current batch completes.  ``acquire`` picks the
    earliest-free lane and returns its start time (``max(now, free)``),
    so with one lane sequential launches model a single predict
    server.
    """

    def __init__(self, slots: int):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.slots = int(slots)
        self.busy_until = [0.0] * self.slots

    def idle_lane(self, now: float) -> Optional[int]:
        """A lane free at ``now`` (the earliest-free one), else None."""
        i = min(range(self.slots), key=lambda j: self.busy_until[j])
        return i if self.busy_until[i] <= now else None

    def acquire(self, now: float) -> Tuple[int, float]:
        """(lane, start): earliest-free lane, start no earlier than its
        current booking — the no-double-booking rule."""
        i = min(range(self.slots), key=lambda j: self.busy_until[j])
        return i, max(now, self.busy_until[i])

    def occupy(self, lane: int, until: float) -> None:
        self.busy_until[lane] = until

    def in_flight(self, now: float) -> int:
        return sum(1 for b in self.busy_until if b > now)


class SlotScheduler:
    """Shared machinery of both batch policies.

    The engine hands the scheduler its clock, tracer, shard router and
    a ``predict_fn(chunk, bucket) -> yhat`` callable (one jitted
    padded-batch predict; the chunk is always one (tenant, shard)
    group, so the model gather stays tenant- and shard-local).  The
    scheduler owns the pending queue, the per-shard slot pools, the
    admission counters and every serving-side statistic; it never sees
    protocol state.
    """

    POLICY = "base"

    def __init__(
        self,
        *,
        clock: Clock,
        predict_fn: Callable,
        shard_of: Callable[[int], int],
        n_shards: int,
        buckets: Sequence[int],
        predict_cost: float,
        slots: int = 1,
        max_queue: Optional[int] = None,
        overload: str = "shed",
        defer_interval: Optional[float] = None,
        tick_interval: float = 1.0,
        slo: Optional[float] = None,
        max_wait: Optional[float] = None,
        tracer=None,
    ):
        if overload not in ("shed", "defer"):
            raise ValueError(f"overload must be 'shed' or 'defer', "
                             f"got {overload!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if slo is not None and slo <= 0:
            raise ValueError(f"slo must be > 0, got {slo}")
        self.clock = clock
        self.tracer = tracer
        self._predict_fn = predict_fn
        self._shard_of = shard_of
        self.buckets = tuple(buckets)
        self.predict_cost = float(predict_cost)
        self.tick_interval = float(tick_interval)
        self.slo = slo
        self.max_queue = max_queue
        self.overload = overload
        # defer retries at half a tick by default: cheaper than a full
        # grid wait, still a real simulated-time price per retry
        self.defer_interval = (float(defer_interval) if defer_interval
                               is not None else 0.5 * self.tick_interval)
        if self.defer_interval <= 0:
            raise ValueError("defer_interval must be > 0")
        # latency-budget hold: how long a launch may wait for fill.
        # Derived from the SLO when not given: the whole budget minus
        # two predict costs of slack (one for the batch itself, one
        # for lane contention).  0 = launch as soon as a lane frees.
        if max_wait is not None:
            self.max_wait = float(max_wait)
        elif slo is not None:
            self.max_wait = max(0.0, float(slo) - 2.0 * self.predict_cost)
        else:
            self.max_wait = 0.0
        self.pools = [SlotPool(slots) for _ in range(n_shards)]
        self.slots = int(slots)

        self.pending: List = []          # admitted, not yet launched
        self.launches = 0
        self.ticks = 0
        self.num_admitted = 0
        self.num_shed = 0
        self.num_deferred = 0
        self.bucket_counts: Counter = Counter()
        self.queue_depth: List[int] = []

    # -- admission -----------------------------------------------------------

    def submit(self, req) -> str:
        """Admission decision for a predict request at ``clock.now``:
        'admit' (queued for a launch), 'shed' (refused, never served)
        or 'defer' (retries ``defer_interval`` later)."""
        if self.max_queue is not None and len(self.pending) >= self.max_queue:
            if self.overload == "shed":
                self.num_shed += 1
                req.shed = True
                if self.tracer is not None:
                    self.tracer.instant(
                        "shed", self.clock.now, pid=PID_SERVING,
                        tid=self.tracer.tid(PID_SERVING, "admission"),
                        args={"uid": req.uid, "queue": len(self.pending)})
                return "shed"
            self.num_deferred += 1
            req.deferrals += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "defer", self.clock.now, pid=PID_SERVING,
                    tid=self.tracer.tid(PID_SERVING, "admission"),
                    args={"uid": req.uid, "retry": req.deferrals,
                          "queue": len(self.pending)})
            self.clock.schedule(self.defer_interval,
                                lambda: self.submit(req))
            return "defer"
        self.pending.append(req)
        self.num_admitted += 1
        self._on_admit(req)
        return "admit"

    # -- shared launch machinery --------------------------------------------

    def _group_key(self, req) -> Tuple[int, int]:
        return (req.tenant, self._shard_of(req.learner))

    def bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise AssertionError(
            f"chunk of {n} exceeds the largest bucket {self.buckets[-1]}")

    def _launch(self, chunk: List, start: float, lane: int) -> float:
        """Run one padded-batch predict for a (tenant, shard) chunk,
        booking [start, start + predict_cost) on ``lane`` of the
        chunk's shard pool; returns the completion time."""
        shard = self._shard_of(chunk[0].learner)
        bucket = self.bucket_of(len(chunk))
        done = start + self.predict_cost
        self.pools[shard].occupy(lane, done)
        yh = self._predict_fn(chunk, bucket)
        for i, r in enumerate(chunk):
            r.yhat = float(yh[i])
            r.done_time = done
        self.launches += 1
        self.bucket_counts[bucket] += 1
        tracer = self.tracer
        if tracer is not None:
            tid = tracer.tid(PID_SERVING, "predict")
            tracer.complete(
                f"predict/bucket{bucket}", start, self.predict_cost,
                pid=PID_SERVING, tid=tid,
                args={"bucket": bucket, "filled": len(chunk),
                      "shard": shard, "tenant": chunk[0].tenant,
                      "lane": lane})
            tracer.counter(
                "serve/bucket_occupancy", start,
                {"filled": len(chunk), "bucket": bucket}, pid=PID_SERVING)
            rtid = tracer.tid(PID_SERVING, "requests")
            for r in chunk:
                tracer.complete(
                    "request", r.arrival, r.done_time - r.arrival,
                    pid=PID_SERVING, tid=rtid,
                    args={"uid": r.uid, "learner": r.learner,
                          "tenant": r.tenant, "bucket": bucket,
                          "deferrals": r.deferrals})
        # the completion lands on the timeline (wall_clock and
        # done_time can never disagree) and wakes the policy
        self.clock.schedule_at(done, self._on_complete)
        return done

    def in_flight(self) -> int:
        now = self.clock.now
        return sum(p.in_flight(now) for p in self.pools)

    def _sample_queue(self) -> None:
        self.queue_depth.append(len(self.pending))
        if self.tracer is not None:
            self.tracer.counter("serve/queue_depth", self.clock.now,
                                {"pending": len(self.pending)},
                                pid=PID_SERVING)

    # -- policy hooks --------------------------------------------------------

    def _on_admit(self, req) -> None:
        raise NotImplementedError

    def _on_complete(self) -> None:
        """A lane freed; the tick policy needs nothing, the continuous
        policy re-checks the queue."""


class TickScheduler(SlotScheduler):
    """The static tick grid, on an integer tick counter.

    Requests wait for the next ``k * tick_interval`` point strictly
    after their arrival; the tick drains the whole pending queue
    through the bucket ladder, chunks booked onto the shard's slot
    pool in sequence.  The grid index k is an INTEGER: each tick time
    is one multiply ``k * tick_interval`` (never an accumulated sum,
    never `floor(now / interval + eps)` float probing), so horizons of
    any length stay exactly on grid — the float-drift regression of
    large ``now`` / tiny ``tick_interval`` cannot occur.
    """

    POLICY = "tick"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._tick_scheduled = False

    def _next_grid_k(self, now: float) -> int:
        """Smallest integer k with k * tick_interval > now, by integer
        stepping from the float-division estimate (the estimate may be
        off by an ulp in either direction; the while loops make the
        answer exact regardless)."""
        q = now / self.tick_interval
        if not math.isfinite(q):
            raise OverflowError(
                f"tick grid index overflow: now={now}, "
                f"tick_interval={self.tick_interval}")
        k = int(q) + 1
        while (k - 1) * self.tick_interval > now:
            k -= 1
        while k * self.tick_interval <= now:
            k += 1
        return k

    def _on_admit(self, req) -> None:
        if self._tick_scheduled:
            return
        self._tick_scheduled = True
        k = self._next_grid_k(self.clock.now)
        self.clock.schedule_at(k * self.tick_interval, self._tick)

    def _tick(self) -> None:
        self._tick_scheduled = False
        self.ticks += 1
        self._sample_queue()
        if not self.pending:
            return
        now = self.clock.now
        groups: Dict[Tuple[int, int], List] = {}
        for r in self.pending:
            groups.setdefault(self._group_key(r), []).append(r)
        max_b = self.buckets[-1]
        for key in sorted(groups):
            shard = key[1]
            group = groups[key]
            for lo in range(0, len(group), max_b):
                chunk = group[lo:lo + max_b]
                lane, start = self.pools[shard].acquire(now)
                self._launch(chunk, start, lane)
        self.pending.clear()


class ContinuousScheduler(SlotScheduler):
    """Continuous batching: admit into free slots on arrival.

    Launch rule, re-evaluated at every admission, completion and hold-
    timer expiry: take the oldest pending request whose shard has an
    idle lane; its (tenant, shard) group launches *now* with size
    ``min(group, buckets[-1])`` — unless the group is under-full AND
    still inside its latency budget (``oldest.arrival + max_wait``),
    in which case a hold timer is armed at exactly that deadline and
    the launch waits for more arrivals.  Under load the hold never
    binds (queues fill a bucket before the deadline) and batches grow
    to the ladder top; when idle a lone request pays at most
    ``max_wait + predict_cost``, never a grid wait — which is exactly
    why continuous batching beats the tick grid at equal p99
    (benchmarks/bench_serve.py, EXPERIMENTS.md §Serving).
    """

    POLICY = "continuous"

    def __init__(self, **kw):
        super().__init__(**kw)
        self._hold: Optional[Event] = None

    def _on_admit(self, req) -> None:
        self._maybe_launch()

    def _on_complete(self) -> None:
        self._maybe_launch()

    def _arm_hold(self, deadline: float) -> None:
        if self._hold is not None and not self._hold.cancelled:
            if self._hold.time <= deadline:
                return                      # an earlier deadline is armed
            self.clock.cancel(self._hold)
        self._hold = self.clock.schedule_at(deadline, self._hold_fired)

    def _hold_fired(self) -> None:
        self._hold = None
        self._maybe_launch()

    def _maybe_launch(self) -> None:
        now = self.clock.now
        while self.pending:
            launched = False
            seen = set()
            for req in self.pending:        # arrival order
                key = self._group_key(req)
                if key in seen:
                    continue
                seen.add(key)
                pool = self.pools[key[1]]
                lane = pool.idle_lane(now)
                if lane is None:
                    continue                # completion will wake us
                group = [r for r in self.pending
                         if self._group_key(r) == key][:self.buckets[-1]]
                if (len(group) < self.buckets[-1] and self.max_wait > 0
                        and now < group[0].arrival + self.max_wait):
                    # inside the latency budget: wait for fill
                    self._arm_hold(group[0].arrival + self.max_wait)
                    continue
                self._sample_queue()
                chunk_ids = {id(r) for r in group}
                self.pending = [r for r in self.pending
                                if id(r) not in chunk_ids]
                self._launch(group, now, lane)
                if self.tracer is not None:
                    self.tracer.counter(
                        "serve/slots_in_flight", now,
                        {"in_flight": self.in_flight()}, pid=PID_SERVING)
                launched = True
                break                       # pending changed: rescan
            if not launched:
                return


def make_scheduler(policy: str, **kw) -> SlotScheduler:
    """Factory over :data:`POLICIES`; keywords are the
    :class:`SlotScheduler` constructor's."""
    if policy == "tick":
        return TickScheduler(**kw)
    if policy == "continuous":
        return ContinuousScheduler(**kw)
    raise ValueError(f"unknown policy {policy!r}; "
                     f"expected one of {POLICIES}")
