"""Observability (port of ``repro.telemetry``).

- trace:   the structured span/counter recorder (Chrome trace JSON).
- monitor: the Def. 1 loss-proportionality monitor.
- probe:   counters of compiled work (nvcc builds, library loads, new
           launch geometries) and wall-clock timers that always wait
           for the card (``time_fn`` / ``wallclock``).
"""
from . import monitor, probe, trace
from .monitor import (CriterionMonitor, MonitorSeries, monitor_population,
                      monitor_result, monitor_sweep, unit_bytes_of)
from .probe import CompileCounter, TimedStats, time_fn, wallclock
from .trace import (PID_MONITOR, PID_NETWORK, PID_RUNTIME, PID_SERVING,
                    TICKS_PER_UNIT, Tracer)

__all__ = ["monitor", "probe", "trace",
           "CriterionMonitor", "MonitorSeries", "monitor_population",
           "monitor_result", "monitor_sweep", "unit_bytes_of",
           "CompileCounter", "TimedStats", "time_fn", "wallclock",
           "PID_MONITOR", "PID_NETWORK", "PID_RUNTIME", "PID_SERVING",
           "TICKS_PER_UNIT", "Tracer"]
