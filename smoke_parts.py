#!/usr/bin/env python3
"""Split each phase of a ``chip_smoke.py`` run into its parts.

    python3 smoke_parts.py [TREE]

``TREE`` (default: this file's directory) holds a ``chip_smoke.py`` and
the ``src/`` it drives.  Its ``main()`` runs unchanged on the card while
wrappers keep an exclusive clock:

- the phase: the outermost call of one of the functions ``main()``
  calls (``run_*``, ``check_*``, ``_build.library``);
- ``profiled``: inside a ``torch.profiler.profile`` window, and reading
  its events afterwards (``_device_seconds``, ``_steps``,
  ``_port_seconds``);
- ``reference``: inside a call of ``engine.run``, ``engine.sweep``,
  ``serve_stream``, ``run_async_simulation`` or ``run_population`` on
  ``backend="reference"`` (by keyword, or a substrate argument on that
  backend), and the LM phases' own controls: ``_greedy_logits`` (the
  teacher-forced flash and plain runs), ``_f32_against_full``, the
  trainer's card-against-CPU and adaptive runs;
- ``timing``: ``time_ms`` and ``flash_timing`` (kernel lines);
- ``reference_wait``: waiting on a result of chip_smoke's second
  process (its reference runs, where the tree has one);
- ``rest``: everything else, the run itself and the unprofiled repeats.

Each outermost entry call is also logged with its backend, whether a
profiler was on, and its seconds, so that a phase's run, repeat and
reference can be told apart by order.  The script prints one JSON line
``{"parts": {phase: {part: s}}, "calls": [...]}`` after chip_smoke's own
output and writes it to ``chiprun_out/smoke_parts_<TREE name>.json``.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: chip_smoke functions whose time is a part of its own (not a phase)
PART_FUNCS = {"_device_seconds": "profiled", "_steps": "profiled",
              "_port_seconds": "profiled", "time_ms": "timing",
              "flash_timing": "timing", "_greedy_logits": "reference",
              "_f32_against_full": "reference",
              "_smoke_on_card_and_cpu": "reference",
              "_adaptive_on_card_and_cpu": "reference"}
#: (module, attribute) of the entry points whose reference runs count
ENTRIES = (("repro_torch.core.engine", "run"),
           ("repro_torch.core.engine", "sweep"),
           ("repro_torch.serving", "serve_stream"),
           ("repro_torch.runtime", "run_async_simulation"),
           ("repro_torch.population", "run_population"))


class Clock:
    """Exclusive seconds by (phase, part): time goes to the top of the
    stack."""

    def __init__(self):
        self.parts = defaultdict(lambda: defaultdict(float))
        self.stack = [("main", "rest")]
        self.last = time.perf_counter()
        self.calls: list = []
        self.in_entry = 0
        self.profiling = 0

    def _tick(self):
        now = time.perf_counter()
        phase, part = self.stack[-1]
        self.parts[phase][part] += now - self.last
        self.last = now

    def push(self, part: str, phase: str | None = None):
        self._tick()
        self.stack.append((phase or self.stack[-1][0], part))

    def pop(self):
        self._tick()
        self.stack.pop()


CLOCK = Clock()


def _phase_wrapper(fn, name):
    def wrapped(*a, **kw):
        outer = CLOCK.stack[-1][0] == "main"
        CLOCK.push("rest", name if outer else None)
        try:
            return fn(*a, **kw)
        finally:
            CLOCK.pop()
    return wrapped


def _part_wrapper(fn, part):
    def wrapped(*a, **kw):
        CLOCK.push(part)
        try:
            return fn(*a, **kw)
        finally:
            CLOCK.pop()
    return wrapped


def _is_reference(a, kw) -> bool:
    if kw.get("backend") == "reference":
        return True
    return any(getattr(x, "backend", None) == "reference" for x in a)


def _entry_wrapper(fn, name):
    def wrapped(*a, **kw):
        if CLOCK.in_entry:
            return fn(*a, **kw)
        ref = _is_reference(a, kw)
        CLOCK.push("reference" if ref else CLOCK.stack[-1][1])
        CLOCK.in_entry += 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            CLOCK.in_entry -= 1
            CLOCK.calls.append({
                "phase": CLOCK.stack[-1][0], "call": name,
                "backend": "reference" if ref else kw.get("backend", "-"),
                "profiled": bool(CLOCK.profiling),
                "s": time.perf_counter() - t0})
            CLOCK.pop()
    return wrapped


def install(smoke) -> None:
    import importlib

    import torch.profiler

    base = torch.profiler.profile

    class Timed(base):
        def __enter__(self):
            CLOCK.push("profiled")
            CLOCK.profiling += 1
            return super().__enter__()

        def __exit__(self, *exc):
            try:
                return super().__exit__(*exc)
            finally:
                CLOCK.profiling -= 1
                CLOCK.pop()

    torch.profiler.profile = Timed
    import concurrent.futures
    concurrent.futures.Future.result = _part_wrapper(
        concurrent.futures.Future.result, "reference_wait")
    for name in dir(smoke):
        fn = getattr(smoke, name)
        if not callable(fn) or isinstance(fn, type):
            continue
        if name in PART_FUNCS:
            setattr(smoke, name, _part_wrapper(fn, PART_FUNCS[name]))
        elif name.startswith(("run_", "check_")):
            setattr(smoke, name, _phase_wrapper(fn, name))
    for mod, attr in ENTRIES:
        m = importlib.import_module(mod)
        setattr(m, attr, _entry_wrapper(getattr(m, attr), attr))
    from repro_torch.kernels import _build
    _build.library = _phase_wrapper(_build.library, "build")


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    # the tree first: chip_smoke's spawned reference process gets this
    # sys.path and imports ``chip_smoke`` by name for its jobs, which
    # must be the tree's (with this file's own beside it, a parent tree's
    # reference runs took this tree's constants)
    sys.path[:0] = [str(tree), str(tree / "src")]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    install(smoke)
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = smoke.main()
    finally:
        # written also when a phase fails: the parts up to it
        CLOCK._tick()
        out = {"tree": str(tree), "rc": rc,
               "total_s": time.perf_counter() - t0,
               "parts": {p: dict(v) for p, v in CLOCK.parts.items()},
               "calls": CLOCK.calls}
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / f"smoke_parts_{tree.name}.json").write_text(
            json.dumps(out, indent=1))
        print(json.dumps({"parts": out["parts"], "total_s": out["total_s"]}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
