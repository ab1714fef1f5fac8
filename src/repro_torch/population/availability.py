"""Availability classes and seeded participation masks (port of
``repro/population/availability.py``, DESIGN.md Sec. 15).

The port's own copy of the reference's pure-numpy module: the same
classes, the same integer SeedSequence tags and the same draws, so a
spec gives the JAX package's masks byte for byte
(tests/test_torch_population.py).

A population of ``m_total`` simulated learners is partitioned into
heterogeneous availability classes.  Each class is a two-state Markov
chain over (on, off) — churn — composed with per-round client sampling
and a device-speed tier:

- ``p_drop``: P(on -> off) per round — a device that churns out
  mid-stream keeps its (now stale) model and stops participating;
- ``p_return``: P(off -> on) per round — recovery.  The engine treats
  the False -> True mask edge as a REJOIN: the device re-``adopt``s the
  coordinator's current reference and the ledger is charged the Sec. 3
  download (``Substrate.rejoin_payload_bytes``);
- ``speed``: the fraction of sampled rounds a device of this tier
  actually completes within the round deadline (slow phones miss
  deadlines; the server drops their contribution, exactly a smaller
  effective cohort);
- the population-level ``sample_rate`` is the coordinator's per-round
  client sampling among currently-available devices.

Everything is derived from ``np.random.default_rng`` seeded with
``np.random.SeedSequence([seed, TAG])`` where the TAGs are fixed module
constants — never string hashes — so masks are byte-identical across
processes and ``PYTHONHASHSEED`` values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

# fixed integer stream tags (never derived from strings: str hashes vary
# under PYTHONHASHSEED, SeedSequence ints do not)
_TAG_ASSIGN = 101   # class assignment permutation
_TAG_INIT = 102     # initial on/off state
_TAG_CHURN = 103    # per-round drop / return draws
_TAG_SAMPLE = 104   # per-round client sampling
_TAG_SPEED = 105    # per-round deadline (speed-tier) draws


@dataclasses.dataclass(frozen=True)
class AvailabilityClass:
    """One device class of the population."""

    name: str
    p_drop: float = 0.0      # P(on -> off) per round
    p_return: float = 1.0    # P(off -> on) per round
    speed: float = 1.0       # P(completes the round | sampled)

    def __post_init__(self):
        for field in ("p_drop", "p_return", "speed"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{field}={v} outside [0, 1]")

    @property
    def stationary_on(self) -> float:
        """Stationary P(on) of the churn chain (1.0 when it never
        drops)."""
        if self.p_drop == 0.0:
            return 1.0
        return self.p_return / (self.p_drop + self.p_return)


# The three canonical tiers of the population experiments
# (EXPERIMENTS.md §Population): datacenter nodes that never churn,
# phone-like devices with duty cycles, and a slow tier that misses
# round deadlines half the time.
ALWAYS_ON = AvailabilityClass("always_on")
PHONE = AvailabilityClass("phone", p_drop=0.15, p_return=0.35)
SLOW = AvailabilityClass("slow", p_drop=0.05, p_return=0.25, speed=0.5)

DEFAULT_MIX: Tuple[Tuple[AvailabilityClass, float], ...] = (
    (ALWAYS_ON, 0.2), (PHONE, 0.5), (SLOW, 0.3))


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """A population: size, class mix, coordinator sampling, seed."""

    m_total: int
    classes: Tuple[Tuple[AvailabilityClass, float], ...] = DEFAULT_MIX
    sample_rate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.m_total < 1:
            raise ValueError(f"need m_total >= 1, got {self.m_total}")
        if not 0.0 < self.sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate {self.sample_rate} outside (0, 1]")
        if not self.classes:
            raise ValueError("need at least one availability class")
        total = sum(frac for _, frac in self.classes)
        if not math.isclose(total, 1.0, rel_tol=0, abs_tol=1e-9):
            raise ValueError(f"class fractions sum to {total}, not 1")


def _rng(spec: PopulationSpec, tag: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([spec.seed, tag]))


def class_assignment(spec: PopulationSpec) -> np.ndarray:
    """(m_total,) int class index per learner.

    Counts are deterministic (largest-remainder apportionment of the
    fractions), the assignment is a seeded permutation — so the class
    histogram is exact, not sampled.
    """
    m = spec.m_total
    fracs = np.asarray([f for _, f in spec.classes], np.float64)
    base = np.floor(fracs * m).astype(np.int64)
    rem = m - int(base.sum())
    # distribute the remainder to the largest fractional parts;
    # np.argsort is stable ("stable" kind), ties break by class order
    order = np.argsort(-(fracs * m - base), kind="stable")
    for k in range(rem):
        base[order[k]] += 1
    ids = np.repeat(np.arange(len(spec.classes)), base)
    return ids[_rng(spec, _TAG_ASSIGN).permutation(m)]


def participation_masks(spec: PopulationSpec, T: int) -> np.ndarray:
    """(T, m_total) bool participation mask of the population.

    Row t is the cohort of round t: available (per-class churn chain)
    AND sampled (coordinator ``sample_rate``) AND completed (speed
    tier).  Same spec + same T => byte-identical array, in-process and
    across interpreters.
    """
    if T < 1:
        raise ValueError(f"need T >= 1, got {T}")
    m = spec.m_total
    cls = class_assignment(spec)
    p_drop = np.asarray([c.p_drop for c, _ in spec.classes])[cls]
    p_return = np.asarray([c.p_return for c, _ in spec.classes])[cls]
    speed = np.asarray([c.speed for c, _ in spec.classes])[cls]
    stat = np.asarray([c.stationary_on for c, _ in spec.classes])[cls]

    on = _rng(spec, _TAG_INIT).random(m) < stat
    churn = _rng(spec, _TAG_CHURN)
    sample = _rng(spec, _TAG_SAMPLE)
    pace = _rng(spec, _TAG_SPEED)
    mask = np.zeros((T, m), bool)
    for t in range(T):
        u = churn.random(m)
        on = np.where(on, u >= p_drop, u < p_return)
        row = on & (sample.random(m) < spec.sample_rate)
        row &= pace.random(m) < speed
        mask[t] = row
    return mask


def rejoin_counts(mask: np.ndarray) -> np.ndarray:
    """(T,) int rejoins per round under the engine's convention: round
    0 has none (the initial reference reached everyone for free), and a
    learner rejoins at t > 0 iff its mask flips False -> True."""
    T = mask.shape[0]
    out = np.zeros(T, np.int64)
    out[1:] = np.sum(mask[1:] & ~mask[:-1], axis=1)
    return out
