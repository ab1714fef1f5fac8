"""The simulated event clock and system model (port of
``repro.runtime.clock``).

Only the clock is ported so far: the serving engine runs on it.  The
asynchronous runtime (transport, nodes, harness, async protocol) waits
for the node-face slice (ROADMAP.md).
"""
from .clock import Clock, Event, SystemConfig, SystemModel, barrier_wall_clock

__all__ = ["Clock", "Event", "SystemConfig", "SystemModel",
           "barrier_wall_clock"]
