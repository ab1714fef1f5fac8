"""Seeded arrival-process generators on the simulated clock (port of
``repro/serving/arrivals.py``).

A copy of the reference's numpy generators: the same ``SeedSequence``
(seed, 0xAA11, class tag) streams and draw order, so ``times(horizon)``
is byte-identical to the reference's (tests/test_torch_serving.py).
The port keeps its own copy because it imports nothing of the JAX
package.

Three processes, all parameterized by a mean ``rate`` (requests per
simulated time unit) so they are comparable at equal offered load:

- :class:`PoissonArrivals` — homogeneous Poisson: i.i.d. exponential
  gaps.
- :class:`BurstyArrivals` — an on/off Markov-modulated Poisson
  process: exponential on/off dwell times, arrivals only while "on" at
  a rate inflated so the long-run mean is ``rate``.
- :class:`DiurnalArrivals` — inhomogeneous Poisson with a raised-
  cosine rate profile between ``trough_rate`` and ``peak_rate``
  (period ``period``), sampled by Lewis-Shedler thinning against the
  peak envelope.

``make_arrivals`` builds any of them by name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

__all__ = ["ArrivalProcess", "PoissonArrivals", "BurstyArrivals",
           "DiurnalArrivals", "make_arrivals", "ARRIVAL_KINDS"]


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Base: a seeded point process on [0, horizon).

    Subclasses implement :meth:`times`; frozen dataclasses so a
    process value-hashes like the substrates do and can key caches /
    parametrize tests directly.
    """

    rate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")

    @property
    def mean_rate(self) -> float:
        """Long-run arrivals per time unit (the offered load)."""
        return self.rate

    #: per-class stream tag: two processes with the same seed but
    #: different kinds never share draws.  A class constant (NOT
    #: ``hash(classname)``, which PYTHONHASHSEED randomizes per
    #: process) so ``times`` is byte-identical across processes.
    _KIND_TAG = 0

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([int(self.seed), 0xAA11, self._KIND_TAG]))

    def times(self, horizon: float) -> np.ndarray:
        """Sorted float64 arrival times in [0, horizon); pure function
        of (config, seed, horizon)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process at ``rate``."""

    _KIND_TAG = 1

    def times(self, horizon: float) -> np.ndarray:
        rng = self._rng()
        out: List[np.ndarray] = []
        t, chunk = 0.0, max(16, int(self.rate * horizon * 1.1) + 8)
        while t < horizon:
            gaps = rng.exponential(1.0 / self.rate, size=chunk)
            ts = t + np.cumsum(gaps)
            out.append(ts)
            t = float(ts[-1])
        ts = np.concatenate(out)
        return ts[ts < horizon]


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """On/off Markov-modulated Poisson process with long-run mean
    ``rate``.

    Dwell times are exponential with means ``mean_on`` / ``mean_off``;
    while on, arrivals are Poisson at ``rate / duty`` where
    ``duty = mean_on / (mean_on + mean_off)`` — so the *burst* rate
    exceeds the mean by 1/duty (4x at the default 25% duty cycle),
    which is exactly the overload a tick-grid scheduler hides and a
    bounded queue must answer with defer-or-shed.
    """

    mean_on: float = 1.0
    mean_off: float = 3.0

    _KIND_TAG = 2

    def __post_init__(self):
        super().__post_init__()
        if self.mean_on <= 0 or self.mean_off < 0:
            raise ValueError("mean_on must be > 0 and mean_off >= 0")

    @property
    def duty(self) -> float:
        return self.mean_on / (self.mean_on + self.mean_off)

    @property
    def burst_rate(self) -> float:
        """Arrival rate while a burst is on (= mean_rate / duty)."""
        return self.rate / self.duty

    def times(self, horizon: float) -> np.ndarray:
        rng = self._rng()
        lam = self.burst_rate
        out: List[float] = []
        t = 0.0
        on = bool(rng.random() < self.duty)   # stationary start
        while t < horizon:
            dwell = rng.exponential(self.mean_on if on else self.mean_off)
            end = min(t + dwell, horizon)
            if on:
                u = t + rng.exponential(1.0 / lam)
                while u < end:
                    out.append(u)
                    u += rng.exponential(1.0 / lam)
            t = t + dwell
            on = not on
        return np.asarray(out, np.float64)


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Inhomogeneous Poisson with a raised-cosine daily profile.

    ``rate(t) = trough + (peak - trough) * (1 - cos(2 pi t / period)) / 2``
    — starts at the trough, crests at ``period / 2``.  ``rate`` (the
    dataclass field) is interpreted as the PEAK rate: SLO questions
    are peak questions.  Sampled by thinning against the peak
    envelope, so determinism needs no closed-form inverse.
    """

    trough_frac: float = 0.2      # trough_rate = trough_frac * peak
    period: float = 20.0

    _KIND_TAG = 3

    def __post_init__(self):
        super().__post_init__()
        if not (0.0 <= self.trough_frac <= 1.0):
            raise ValueError("trough_frac in [0, 1]")
        if self.period <= 0:
            raise ValueError("period must be > 0")

    @property
    def peak_rate(self) -> float:
        return self.rate

    @property
    def trough_rate(self) -> float:
        return self.trough_frac * self.rate

    @property
    def mean_rate(self) -> float:
        # mean of the raised cosine: midway between trough and peak
        return 0.5 * (self.trough_rate + self.peak_rate)

    def rate_at(self, t: float) -> float:
        swell = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / self.period))
        return self.trough_rate + (self.peak_rate - self.trough_rate) * swell

    def times(self, horizon: float) -> np.ndarray:
        rng = self._rng()
        out: List[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / self.peak_rate)
            if t >= horizon:
                break
            # thin: keep with prob rate(t)/peak (one uniform per
            # candidate, drawn unconditionally => deterministic order)
            if rng.random() < self.rate_at(t) / self.peak_rate:
                out.append(t)
        return np.asarray(out, np.float64)


ARRIVAL_KINDS = ("poisson", "bursty", "diurnal")


def make_arrivals(kind: str, rate: float, seed: int = 0,
                  **kw) -> ArrivalProcess:
    """Factory over :data:`ARRIVAL_KINDS`; extra keywords go to the
    process (``mean_on``/``mean_off``, ``trough_frac``/``period``)."""
    if kind == "poisson":
        return PoissonArrivals(rate=rate, seed=seed, **kw)
    if kind == "bursty":
        return BurstyArrivals(rate=rate, seed=seed, **kw)
    if kind == "diurnal":
        return DiurnalArrivals(rate=rate, seed=seed, **kw)
    raise ValueError(f"unknown arrival kind {kind!r}; "
                     f"expected one of {ARRIVAL_KINDS}")
