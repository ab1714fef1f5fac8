"""``repro_torch.telemetry.probe`` on the CPU.

The port's compiled work is the nvcc build of ``kernels/csrc`` with its
library load and the launch geometries of ``kernels/fused.py`` and
``kernels/rff.py``.  Each cache reports a miss through
``kernels._build.note_compile``: a counter sees every miss while it is
active, counters nest, a counter that has exited sees nothing, and a
hit adds nothing.  ``time_fn`` and ``wallclock`` fill their fields.
The nvcc build itself needs the card's toolkit: tests/test_torch_cuda.py
and chip_smoke.py count it there.
"""
import time

import torch

from repro_torch import telemetry
from repro_torch.kernels import _build, fused
from repro_torch.kernels import rff as rffmod
from repro_torch.telemetry import CompileCounter, probe, time_fn, wallclock


def test_each_geometry_miss_counts_once_and_hits_add_nothing():
    fused.sv_predict_geometry.cache_clear()
    fused.primal_step_geometry.cache_clear()
    rffmod.rff_geometry.cache_clear()
    with CompileCounter() as c:
        fused.sv_predict_geometry(1024, 18)
        fused.primal_step_geometry(2048, True)
        rffmod.rff_geometry(64, 2048)
        assert c.compiles == 3
        assert c.events == ["sv_predict_geometry", "primal_step_geometry",
                            "rff_geometry"]
        fused.sv_predict_geometry(1024, 18)
        fused.primal_step_geometry(2048, True)
        rffmod.rff_geometry(64, 2048)
        assert c.compiles == 3
        fused.sv_predict_geometry(1025, 18)
        assert c.compiles == 4
    assert fused.sv_predict_geometry(1024, 18) == (8, 128)
    assert fused.sv_predict_geometry.cache_info().hits >= 2


def test_counters_nest_and_do_not_leak():
    before = list(_build.COMPILE_LISTENERS)
    with CompileCounter() as outer:
        _build.note_compile("nvcc", 1.5)
        with CompileCounter() as inner:
            _build.note_compile("load", 0.25)
        _build.note_compile("rff_geometry")
    _build.note_compile("nvcc", 9.0)
    assert (outer.compiles, inner.compiles) == (3, 1)
    assert outer.events == ["nvcc", "load", "rff_geometry"]
    assert outer.compile_secs == 1.75 and inner.compile_secs == 0.25
    assert _build.COMPILE_LISTENERS == before


def test_time_fn_and_wallclock_fill_their_fields():
    calls = []

    def fn(x):
        calls.append(1)
        if len(calls) == 1:
            fused.sv_predict_geometry(999_999, 3)   # a compile in warm-up
        return {"y": x * 2, "n": [x + 1]}

    fused.sv_predict_geometry.cache_clear()
    stats = time_fn(fn, torch.ones(4), warmup=2, iters=3)
    assert isinstance(stats, telemetry.TimedStats)
    assert len(calls) == 5 and stats.iters == 3
    assert stats.warmup_compiles == 1 and stats.compiles == 0
    assert stats.us_per_call > 0 and stats.compile_secs >= 0
    with wallclock() as w:
        time.sleep(0.01)
        out = w.track(fn(torch.zeros(2)))
        fused.sv_predict_geometry(999_998, 3)
    assert w.seconds >= 0.01 and w.compiles == 1
    assert torch.equal(out["y"], torch.zeros(2))
    probe.block([out, None, 3.0])          # CPU tensors: nothing to wait for
