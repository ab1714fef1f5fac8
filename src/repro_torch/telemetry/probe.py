"""Compile counters and honest wall-clock probes (port of
``repro/telemetry/probe.py``, DESIGN.md Sec. 11).

Two measurement hazards this module closes:

- **Phantom speed.** CUDA launches are asynchronous: timing ``fn(x)``
  without waiting measures how fast Python enqueues work.  Every timer
  here waits with ``torch.cuda.synchronize(device)`` for each CUDA
  device that holds a tensor of the produced values, in the warm-up and
  in the timed region, as the reference blocks on
  ``jax.block_until_ready``.

- **Silent recompiles.** The port's compiled work comes from three
  caches: the nvcc build of ``kernels/csrc`` (cached on disk by a hash
  of the sources) with its library load, and the launch geometries of
  ``kernels/fused.py`` and ``kernels/rff.py``.  Each reports a miss
  through ``kernels._build.note_compile``; :class:`CompileCounter`
  counts those reports, so "this call compiles nothing new" is an
  assertable property, as the reference's backend-compile counter makes
  it.

A counter adds itself to ``_build.COMPILE_LISTENERS`` on entry and
takes itself off on exit, so counters nest and never leak.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch

from ..kernels import _build
from ..tree import leaves


class CompileCounter:
    """Context manager counting compiled work in its scope::

        with CompileCounter() as c:
            engine.run(cfg, pcfg, X, Y)      # may build, load, or miss
            n = c.compiles
            engine.run(cfg, pcfg, X, Y)      # every cache hits
        assert c.compiles == n

    ``compiles`` counts an nvcc build, a library load and each new
    launch geometry; ``events`` names them in order.  Regression tests
    assert deltas ("the second call adds zero").  Counters may nest;
    each sees all compiles while it is active.
    """

    def __init__(self) -> None:
        self.compiles = 0
        self.compile_secs = 0.0
        self.events: List[str] = []

    def __call__(self, what: str, seconds: float) -> None:
        self.compiles += 1
        self.compile_secs += seconds
        self.events.append(what)

    def __enter__(self) -> "CompileCounter":
        _build.COMPILE_LISTENERS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _build.COMPILE_LISTENERS.remove(self)


def block(value) -> None:
    """Wait for every CUDA device holding a tensor of ``value`` (a
    tensor or a pytree of them; other leaves are ignored)."""
    devices = {x.device for x in leaves(value)
               if torch.is_tensor(x) and x.device.type == "cuda"}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class TimedStats:
    """What :func:`time_fn` measured."""

    us_per_call: float       # mean wall time per timed call, waited for
    iters: int
    compiles: int            # compiles during the TIMED loop
    warmup_compiles: int     # compiles during warmup
    compile_secs: float      # seconds spent compiling during warmup


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            ) -> TimedStats:
    """Time ``fn(*args)``, waiting for its outputs every iteration.

    Warm-up calls absorb compilation (reported as ``warmup_compiles`` /
    ``compile_secs``); if anything compiles inside the timed loop,
    ``compiles`` is nonzero and the number is not steady state.
    """
    with CompileCounter() as cw:
        for _ in range(max(warmup, 0)):
            block(fn(*args))
    with CompileCounter() as ct:
        t0 = time.perf_counter()
        for _ in range(iters):
            block(fn(*args))
        wall = time.perf_counter() - t0
    return TimedStats(us_per_call=wall / iters * 1e6, iters=iters,
                      compiles=ct.compiles, warmup_compiles=cw.compiles,
                      compile_secs=cw.compile_secs)


class Wallclock:
    """Handle yielded by :class:`wallclock`; ``track`` registers device
    values the elapsed time must wait for."""

    def __init__(self) -> None:
        self.seconds: float = 0.0
        self.compiles: int = 0
        self._tracked: List[Any] = []

    def track(self, value):
        """Register a tensor (or pytree of tensors); returns it."""
        self._tracked.append(value)
        return value


class wallclock:
    """Timing context that always waits for tracked device values::

        with wallclock() as w:
            out = w.track(step(state, batch))
        w.seconds, w.compiles

    On a clean exit the context waits for everything ``track``ed, then
    records the elapsed seconds and the compiles seen inside.
    """

    def __init__(self) -> None:
        self._w = Wallclock()
        self._counter = CompileCounter()

    def __enter__(self) -> Wallclock:
        self._counter.__enter__()
        self._t0 = time.perf_counter()
        return self._w

    def __exit__(self, *exc) -> Optional[bool]:
        try:
            if exc == (None, None, None):
                block(self._w._tracked)
        finally:
            self._w.seconds = time.perf_counter() - self._t0
            self._counter.__exit__(*exc)
            self._w.compiles = self._counter.compiles
        return None
