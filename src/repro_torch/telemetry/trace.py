"""Structured event-clock tracing (port of ``repro/telemetry/trace.py``).

A copy of the reference's :class:`Tracer` (pure Python + ``json``):
spans, counters and instants exported in the Chrome trace-event JSON
format, so a serving run can be opened in Perfetto
(https://ui.perfetto.dev).  The port keeps its own copy because it
imports nothing of the JAX package; the export of a serving run is
byte-identical to the reference's on the same inputs
(tests/test_torch_serving.py).

- **Simulated time only.**  Every timestamp is a value of the
  discrete-event clock (``runtime.clock.Clock.now``), never the host's
  wall clock, so a trace is a pure function of the run's seeds.  One
  simulated time unit maps to ``TICKS_PER_UNIT`` microseconds of trace
  time.
- **Zero cost when absent.**  Nothing constructs a Tracer unless the
  caller passes one; every instrumentation site is guarded by
  ``if tracer is not None`` on the host.

Export format: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``
with the standard phases — ``X`` (complete span with ``dur``), ``C``
(counter), ``i`` (instant), ``M`` (process/thread name metadata).
``pid`` groups events into named tracks; ``tid`` lanes within a pid
are handed out by :meth:`Tracer.tid` in first-use order.

The serving engine uses four PID_SERVING lanes: ``requests`` (enqueue
instants + per-request spans), ``predict`` (padded-batch launch spans,
one per ``predict/bucketN``), ``protocol`` (round instants +
sync/transfer spans) and ``admission`` (shed/defer instants) — plus
the ``serve/queue_depth``, ``serve/bucket_occupancy`` and
``serve/slots_in_flight`` counter tracks.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

#: One simulated time unit (`Clock.now == 1.0`) = 1e6 trace
#: microseconds, so `base_compute = 1.0` rounds render as 1 s slices.
TICKS_PER_UNIT = 1_000_000.0

# Process-track ids.  Keep these stable: bench tooling and tests match
# on them, and a renumbering would silently re-lane existing traces.
PID_RUNTIME = 1    # learner rounds + coordinator episodes (nodes.py)
PID_NETWORK = 2    # message spans with Sec. 3 byte args (transport.py)
PID_SERVING = 3    # request/bucket/round spans (serving/engine.py)
PID_MONITOR = 4    # loss-proportionality counter tracks (monitor.py)

_PID_NAMES = {
    PID_RUNTIME: "runtime",
    PID_NETWORK: "network",
    PID_SERVING: "serving",
    PID_MONITOR: "monitor",
}


class Tracer:
    """Append-only recorder of Chrome trace events on simulated time.

    All ``ts`` / ``dur`` arguments are in simulated clock units (or
    round indices, for clockless sources like ``engine.run`` series);
    the tracer scales them by :data:`TICKS_PER_UNIT` at record time.
    ``args`` values must be JSON-serializable scalars — keep them to
    ints, floats, bools and short strings, they are what Perfetto
    shows in the selection panel.
    """

    def __init__(self) -> None:
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[Tuple[int, str], int] = {}
        self._named_pids: set = set()

    # -- track naming --------------------------------------------------------

    def _ensure_pid(self, pid: int) -> None:
        if pid in self._named_pids:
            return
        self._named_pids.add(pid)
        name = _PID_NAMES.get(pid, f"pid{pid}")
        self._events.append({"ph": "M", "name": "process_name",
                             "pid": pid, "tid": 0,
                             "args": {"name": name}})

    def tid(self, pid: int, lane: str) -> int:
        """Stable integer lane id for a named lane within ``pid``;
        assigns ids in first-use order and emits the thread-name
        metadata event on first use."""
        key = (pid, lane)
        if key not in self._tids:
            self._ensure_pid(pid)
            t = len([1 for (p, _) in self._tids if p == pid])
            self._tids[key] = t
            self._events.append({"ph": "M", "name": "thread_name",
                                 "pid": pid, "tid": t,
                                 "args": {"name": lane}})
        return self._tids[key]

    # -- recording -----------------------------------------------------------

    def complete(self, name: str, ts: float, dur: float, *,
                 pid: int = PID_RUNTIME, tid: int = 0,
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A span [ts, ts + dur) in simulated time (phase ``X``)."""
        self._ensure_pid(pid)
        ev: Dict[str, Any] = {
            "ph": "X", "name": name, "pid": pid, "tid": tid,
            "ts": ts * TICKS_PER_UNIT, "dur": dur * TICKS_PER_UNIT}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, ts: float, *,
                pid: int = PID_RUNTIME, tid: int = 0,
                args: Optional[Dict[str, Any]] = None) -> None:
        """A point event (phase ``i``, thread scope)."""
        self._ensure_pid(pid)
        ev: Dict[str, Any] = {
            "ph": "i", "name": name, "pid": pid, "tid": tid,
            "ts": ts * TICKS_PER_UNIT, "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, ts: float, values: Dict[str, float], *,
                pid: int = PID_RUNTIME, tid: int = 0) -> None:
        """One sample on a counter track (phase ``C``); ``values`` maps
        series name -> numeric sample, all plotted on one track.
        ``tid`` places the track on a named lane (``Tracer.tid``) so
        per-lane counters — e.g. the serving scheduler's per-shard
        slot occupancy — group under their lane instead of lane 0."""
        self._ensure_pid(pid)
        self._events.append({
            "ph": "C", "name": name, "pid": pid, "tid": tid,
            "ts": ts * TICKS_PER_UNIT, "args": dict(values)})

    # -- export --------------------------------------------------------------

    @property
    def events(self) -> List[Dict[str, Any]]:
        return self._events

    def __len__(self) -> int:
        return len(self._events)

    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": self._events, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Canonical serialization: sorted keys, fixed separators — the
        byte-identical-under-seed contract depends on this being a pure
        function of the recorded event sequence."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path) -> None:
        """Write Perfetto-loadable JSON to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
