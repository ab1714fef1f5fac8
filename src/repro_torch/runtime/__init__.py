"""Asynchronous event-driven protocol runtime (port of
``repro/runtime``).

- clock:          discrete-event queue + seeded latency/straggler/failure
                  models; deterministic under seed.
- transport:      delta-encoded messages metered with the Sec. 3
                  ByteModel; per-link byte/latency stats.
- nodes:          LearnerNode (any core.substrate learner on its own
                  stream, its model on the device) and CoordinatorNode
                  (staleness-weighted aggregation, no global barrier).
- async_protocol: async sigma_periodic / sigma_dynamic policy + the
                  FedAsync staleness schedules.
- harness:        ``run_async_simulation``, an AsyncSimResult with the
                  engine's SimResult fields; any substrate (SV / RFF /
                  linear), ``device=`` as every entry point of the port.
"""
from . import async_protocol, clock, harness, nodes, transport
from .async_protocol import AsyncProtocolConfig, staleness_weight
from .clock import Clock, Event, SystemConfig, SystemModel, barrier_wall_clock
from .harness import (AsyncSimResult, run_async_kernel_simulation,
                      run_async_linear_simulation, run_async_simulation)
from .nodes import CoordinatorNode, LearnerNode
from .transport import Message, Network

__all__ = [
    "async_protocol", "clock", "harness", "nodes", "transport",
    "AsyncProtocolConfig", "staleness_weight",
    "Clock", "Event", "SystemConfig", "SystemModel", "barrier_wall_clock",
    "AsyncSimResult", "run_async_kernel_simulation",
    "run_async_linear_simulation", "run_async_simulation",
    "CoordinatorNode", "LearnerNode", "Message", "Network",
]
