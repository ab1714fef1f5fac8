"""Population layer (port of ``repro.population``): 10^5-10^6 simulated
learners with churn and partial participation (DESIGN.md Sec. 15)."""
from .availability import (ALWAYS_ON, DEFAULT_MIX, PHONE, SLOW,
                           AvailabilityClass, PopulationSpec,
                           class_assignment, participation_masks,
                           rejoin_counts)
from .sim import PopulationResult, run_population, trace_population

__all__ = [
    "AvailabilityClass", "PopulationSpec",
    "ALWAYS_ON", "PHONE", "SLOW", "DEFAULT_MIX",
    "class_assignment", "participation_masks", "rejoin_counts",
    "PopulationResult", "run_population", "trace_population",
]
