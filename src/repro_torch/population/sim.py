"""Population simulation (port of ``repro/population/sim.py``,
DESIGN.md Sec. 15).

``run_population`` drives ``engine.run(participation=)`` over a
:class:`~repro_torch.population.availability.PopulationSpec`: the
population is the engine's stacked learner axis, the per-round cohort
is the seeded participation mask, and the result couples the engine's
``SimResult`` (Sec. 3 bytes over the participating cohort only) with
the population's observables (cohort sizes, rejoin counts, class
assignment).

Scale: the SV substrate's device ledger refuses populations whose
worst-case sync bytes overflow the reference's int32
(``accounting.check_kernel_sync_capacity``), so population-scale runs
use the linear or RFF substrates, whose sync costs the fixed
``2 c |theta| B`` of the cohort.  On the card a linear round of
10^5 learners is one ``primal_step`` launch under ``backend="kernels"``.

Determinism: the masks come from ``availability.participation_masks``
(integer-tagged SeedSequences), the engine is deterministic, and the
trace :func:`trace_population` writes is byte-identical across runs
and equal to the JAX package's for the same result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import engine
from ..core.protocol import ProtocolConfig
from ..core.simulation import SimResult
from ..telemetry.trace import PID_RUNTIME, Tracer
from .availability import (PopulationSpec, class_assignment,
                           participation_masks, rejoin_counts)


@dataclasses.dataclass
class PopulationResult:
    """A population run: the engine result plus cohort observables."""

    sim: SimResult
    participation: np.ndarray    # (T, m) bool, the mask that ran
    cohort_sizes: np.ndarray     # (T,) int64 participants per round
    rejoins: np.ndarray          # (T,) int64 rejoin events per round
    class_ids: np.ndarray        # (m,) int class index per learner

    @property
    def mean_cohort(self) -> float:
        return float(self.cohort_sizes.mean())

    @property
    def total_rejoins(self) -> int:
        return int(self.rejoins.sum())


def run_population(
    spec: PopulationSpec,
    learner,
    pcfg: ProtocolConfig,
    X: np.ndarray,          # (T, m_total, d)
    Y: np.ndarray,          # (T, m_total)
    *,
    mesh=None,
    topology: str = "coordinator",
    record_divergence: bool = False,
    participation: Optional[np.ndarray] = None,
    device=None,
) -> PopulationResult:
    """Run the population over a labeled stream on ``device`` (default
    the CUDA card).

    ``X`` / ``Y`` carry the whole population's stream; learners outside
    a round's cohort never touch their row.  ``participation``
    overrides the spec's mask (same (T, m) shape): an all-True override
    reproduces ``engine.run`` bitwise.  ``mesh`` (a
    ``launch.mesh.LearnerMesh``) shards the population over its devices
    exactly as ``engine.run`` documents.
    """
    T, m = np.shape(X)[:2]
    if m != spec.m_total:
        raise ValueError(
            f"stream learner axis {m} != spec.m_total {spec.m_total}")
    if participation is None:
        mask = participation_masks(spec, T)
    else:
        mask = np.asarray(participation, bool)
        if mask.shape != (T, m):
            raise ValueError(
                f"participation shape {mask.shape} != {(T, m)}")
    sim = engine.run(learner, pcfg, X, Y, mesh=mesh, topology=topology,
                     record_divergence=record_divergence,
                     participation=mask, device=device)
    return PopulationResult(
        sim=sim,
        participation=mask,
        cohort_sizes=mask.sum(axis=1).astype(np.int64),
        rejoins=rejoin_counts(mask),
        class_ids=class_assignment(spec),
    )


def trace_population(result: PopulationResult, tracer: Tracer, *,
                     name: str = "population") -> None:
    """Write the population observables into a Chrome trace: cohort
    size and cumulative rejoins as counter tracks on round-index time,
    plus an instant per sync round carrying the round's cohort.  All
    values are ints from deterministic arrays, so the emitted trace is
    byte-identical for byte-identical results."""
    cum_rejoins = 0
    sync_set = {int(t) for t in np.asarray(result.sim.sync_rounds)}
    for t in range(len(result.cohort_sizes)):
        cum_rejoins += int(result.rejoins[t])
        tracer.counter(f"{name}/cohort", float(t),
                       {"participants": int(result.cohort_sizes[t]),
                        "rejoins": cum_rejoins},
                       pid=PID_RUNTIME)
        if t in sync_set:
            tracer.instant(f"{name}/sync", float(t), pid=PID_RUNTIME,
                           args={"round": t,
                                 "cohort": int(result.cohort_sizes[t])})
