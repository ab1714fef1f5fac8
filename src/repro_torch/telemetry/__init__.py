"""Observability (port of ``repro.telemetry``): the trace recorder and
the Def. 1 loss-proportionality monitor.

``probe`` (the reference's JAX compile counters) waits for the
telemetry slice (ROADMAP.md).
"""
from . import monitor, trace
from .monitor import (CriterionMonitor, MonitorSeries, monitor_population,
                      monitor_result, monitor_sweep, unit_bytes_of)
from .trace import (PID_MONITOR, PID_NETWORK, PID_RUNTIME, PID_SERVING,
                    TICKS_PER_UNIT, Tracer)

__all__ = ["monitor", "trace",
           "CriterionMonitor", "MonitorSeries", "monitor_population",
           "monitor_result", "monitor_sweep", "unit_bytes_of",
           "PID_MONITOR", "PID_NETWORK", "PID_RUNTIME", "PID_SERVING",
           "TICKS_PER_UNIT", "Tracer"]
