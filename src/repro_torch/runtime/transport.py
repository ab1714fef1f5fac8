"""Message transport with delta-encoded model payloads (port of
``repro/runtime/transport.py``, host-only: the same routing, metering,
draw order and trace events).

Payload sizing follows the Sec. 3 accounting of ``core.accounting``: a
support-vector expansion shipped over a link costs

    |S| * B_alpha  +  |S \\ known| * B_x

where ``known`` is the set of sv_ids the *receiver* already holds.
Summed over one full m-learner synchronization this is
``accounting.sync_bytes_kernel`` to the byte.

The :class:`Network` routes messages between registered nodes through
the discrete-event clock, applying the system model's latency,
bandwidth and drop behaviour, and meters bytes / message counts /
cumulative latency per directed link.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

# Payload sizing lives with the rest of the byte accounting; the
# substrate chooses which sizing applies to each upload/download.
# Re-exported here for the transport's users.
from ..core.accounting import (ByteModel, idset, kernel_payload_bytes,
                               linear_payload_bytes)
from ..telemetry.trace import PID_NETWORK, Tracer
from .clock import Clock, SystemModel


# ---------------------------------------------------------------------------
# Messages and links
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Message:
    src: str
    dst: str
    kind: str                 # "report" | "pull" | "upload" | "download"
    payload: Any
    nbytes: int
    send_time: float
    deliver_time: float = 0.0
    round: int = -1           # learner round the content corresponds to


@dataclasses.dataclass
class LinkStats:
    messages: int = 0
    bytes: int = 0
    dropped: int = 0
    total_latency: float = 0.0

    @property
    def delivered(self) -> int:
        return self.messages - self.dropped

    @property
    def mean_latency(self) -> float:
        return self.total_latency / self.delivered if self.delivered else 0.0


class Network:
    """Event-driven message fabric between named nodes."""

    def __init__(self, clock: Clock, model: SystemModel,
                 tracer: Optional[Tracer] = None):
        self.clock = clock
        self.model = model
        # default to the clock's tracer so one handle threads the run
        self.tracer = tracer if tracer is not None else clock.tracer
        self._nodes: Dict[str, Callable[[Message], None]] = {}
        self.links: Dict[Tuple[str, str], LinkStats] = {}
        self.total_bytes = 0
        self.dropped = 0
        # metadata-only trace: payloads are model references and would
        # pin every historical model for the run's lifetime.
        self.sent: list = []    # (round, nbytes, kind) at send time

    def register(self, name: str, handler: Callable[[Message], None]) -> None:
        if name in self._nodes:
            raise ValueError(f"duplicate node name {name!r}")
        self._nodes[name] = handler

    def send(self, src: str, dst: str, kind: str, payload: Any,
             nbytes: int, round: int = -1) -> Message:
        """Meter and enqueue a message; delivery is a clock event."""
        if dst not in self._nodes:
            raise KeyError(f"unknown destination {dst!r}")
        stats = self.links.setdefault((src, dst), LinkStats())
        msg = Message(src=src, dst=dst, kind=kind, payload=payload,
                      nbytes=nbytes, send_time=self.clock.now, round=round)
        # bytes leave the sender even if the network then loses them
        stats.messages += 1
        stats.bytes += nbytes
        self.total_bytes += nbytes
        self.sent.append((round, nbytes, kind))
        if self.model.drop():
            stats.dropped += 1
            self.dropped += 1
            if self.tracer is not None:
                self.tracer.instant(
                    f"drop/{kind}", self.clock.now, pid=PID_NETWORK,
                    tid=self.tracer.tid(PID_NETWORK, f"{src}->{dst}"),
                    args={"src": src, "dst": dst, "nbytes": nbytes,
                          "round": round})
            return msg
        latency = self.model.draw_latency(nbytes)
        stats.total_latency += latency
        msg.deliver_time = self.clock.now + latency
        if self.tracer is not None:
            # one span per message, send -> deliver, carrying the
            # Sec. 3 byte annotation: the nbytes
            # args summed over msg/* spans plus drop/* instants ARE
            # the run's total_bytes (bytes leave the sender either way)
            self.tracer.complete(
                f"msg/{kind}", msg.send_time, latency, pid=PID_NETWORK,
                tid=self.tracer.tid(PID_NETWORK, f"{src}->{dst}"),
                args={"src": src, "dst": dst, "nbytes": nbytes,
                      "round": round})
        self.clock.schedule(latency, lambda: self._deliver(msg))
        return msg

    def _deliver(self, msg: Message) -> None:
        self._nodes[msg.dst](msg)

    def link_bytes(self) -> Dict[str, int]:
        return {f"{s}->{d}": st.bytes for (s, d), st in self.links.items()}
