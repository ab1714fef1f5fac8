"""Observability (port of ``repro.telemetry``): the trace recorder.

``monitor`` and ``probe`` wait for the telemetry slice (ROADMAP.md).
"""
from .trace import (PID_MONITOR, PID_NETWORK, PID_RUNTIME, PID_SERVING,
                    TICKS_PER_UNIT, Tracer)

__all__ = ["PID_MONITOR", "PID_NETWORK", "PID_RUNTIME", "PID_SERVING",
           "TICKS_PER_UNIT", "Tracer"]
