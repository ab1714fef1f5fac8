"""``repro_torch.telemetry.monitor`` against ``repro.telemetry.monitor``,
mirroring tests/test_telemetry.py:179-260.

The Def. 1 monitor over the port's entry points (``engine.run``,
``engine.sweep``, the asynchronous harness, ``ServeResult.sim``) for
{SV, RFF, linear}: its series adopt the run's bitwise (losses) and
integer-exactly (bytes); against the JAX package's monitor over the
JAX package's run on the same inputs, the per-sync unit, the byte
series and the violation round are equal and the loss series within
the parity pair.  A monitor fed the same increments emits the JAX
package's trace JSON byte for byte.
"""
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import rff as jrff
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import susy_stream
from repro.runtime import AsyncProtocolConfig as JAsync
from repro.runtime import SystemConfig as JSystem
from repro.runtime import run_async_simulation as jasync
from repro.serving import serve_stream as jserve
from repro.telemetry import monitor as jmon
from repro.telemetry.trace import Tracer as JTracer

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.runtime import AsyncProtocolConfig as TAsync
from repro_torch.runtime import SystemConfig as TSystem
from repro_torch.runtime import run_async_simulation as tasync
from repro_torch.serving import serve_stream as tserve
from repro_torch.telemetry import Tracer as TTracer
from repro_torch.telemetry import monitor as tmon

D = 8
T, M = 150, 4
SV_KW = dict(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01, budget=32,
             dim=D)
LIN_KW = dict(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001, dim=D)
_JRFF = JRFFSpec(dim=D, num_features=64, gamma=0.3, seed=0)
X, Y = susy_stream(T=T, m=M, d=D, seed=0)


def _learners(name):
    """(reference learner, port learner): tests/test_telemetry.py's."""
    if name == "sv":
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **SV_KW),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **SV_KW))
    if name == "rff":
        W, b = jrff.rff_params(_JRFF)
        return _JRFF, convert.rff_spec(_JRFF, W, b)
    return JLearner(**LIN_KW), TLearner(**LIN_KW)


NAMES = ("sv", "rff", "linear")
PCFG = dict(kind="dynamic", delta=2.0)
ACFG = dict(kind="dynamic", delta=2.0, alpha=1.0, staleness="constant")


def _assert_monitors_agree(got, want, backend_parity, label):
    assert got.m == want.m and got.unit_bytes == want.unit_bytes, label
    g, w = got.series(), want.series()
    assert g.cumulative_bytes.dtype == np.int64
    np.testing.assert_array_equal(g.cumulative_bytes, w.cumulative_bytes,
                                  err_msg=label)
    backend_parity(g.cumulative_loss, w.cumulative_loss, label)
    backend_parity(g.bound, w.bound, label)
    assert got.violation_round == want.violation_round, label


@pytest.mark.parametrize("source", ["engine", "async", "serving"])
@pytest.mark.parametrize("name", NAMES)
def test_monitor_exact_across_entry_points(name, source, backend_parity):
    """The monitor's series are the run's (bitwise losses,
    integer-exact bytes), the dynamic protocol satisfies the criterion,
    and the port's monitor is the JAX package's on the same run."""
    jl, tl = _learners(name)
    if source == "engine":
        got = teng.run(tl, TProtocol(**PCFG), X, Y, device="cpu")
        want = jeng.run(jl, JProtocol(**PCFG), X, Y)
    elif source == "async":
        got = tasync(tl, TAsync(**ACFG), X, Y, sys_cfg=TSystem(),
                     device="cpu")
        want = jasync(jl, JAsync(**ACFG), X, Y, sys_cfg=JSystem())
    else:
        got = tserve(tl, TProtocol(**PCFG), X, Y, queries_per_round=1.0,
                     device="cpu").sim
        want = jserve(jl, JProtocol(**PCFG), X, Y,
                      queries_per_round=1.0).sim
    mon = tmon.monitor_result(got, tl, M)
    s = mon.series()
    np.testing.assert_array_equal(s.cumulative_bytes, got.cumulative_bytes)
    assert s.cumulative_loss.tobytes() == np.asarray(
        got.cumulative_loss, np.float64).tobytes()
    assert len(s) == T and s.ok and mon.ok
    _assert_monitors_agree(mon, jmon.monitor_result(want, jl, M),
                           backend_parity, f"{name}/{source}")


@pytest.mark.parametrize("name", NAMES)
def test_monitor_sweep_matches_per_config_ledgers(name, backend_parity):
    jl, tl = _learners(name)
    grid = [dict(kind="dynamic", delta=d) for d in (0.5, 2.0)]
    sw = teng.sweep(tl, [TProtocol(**p) for p in grid], X, Y, device="cpu")
    mons = tmon.monitor_sweep(sw, tl, M)
    want = jmon.monitor_sweep(
        jeng.sweep(jl, [JProtocol(**p) for p in grid], X, Y), jl, M)
    assert len(mons) == len(grid)
    for i, mon in enumerate(mons):
        np.testing.assert_array_equal(mon.series().cumulative_bytes,
                                      sw[i].cumulative_bytes)
        assert mon.ok
        _assert_monitors_agree(mon, want[i], backend_parity, f"{name}[{i}]")


@pytest.mark.parametrize("topology", ["coordinator", "allreduce"])
@pytest.mark.parametrize("name", NAMES)
def test_monitor_unit_bytes_equal_the_reference(name, topology):
    jl, tl = _learners(name)
    for m in (1, 2, M, 37):
        assert tmon.unit_bytes_of(tl, m, topology) == jmon.unit_bytes_of(
            jl, m, topology), (name, m)
    # coordinator SV worst case: full-budget novel uploads + union
    # downloads (tests/test_telemetry.py:209)
    ub = tmon.unit_bytes_of(_learners("sv")[1], M)
    bx, ba, tau = D * 4 + 4, 4 + 4, SV_KW["budget"]
    assert ub == (M * tau * (ba + bx) + M * M * tau * ba
                  + M * (M - 1) * tau * bx)
    assert tmon.unit_bytes_of(_learners("linear")[1], M) == 2 * M * (D + 1) * 4
    with pytest.raises(ValueError):
        tmon.unit_bytes_of(tl, M, "ring")


def test_monitor_flags_disproportionate_communication():
    mons = [tmon.CriterionMonitor(m=2, unit_bytes=100, slack=1.0,
                                  loss_floor=1.0),
            jmon.CriterionMonitor(m=2, unit_bytes=100, slack=1.0,
                                  loss_floor=1.0)]
    for mon in mons:
        assert mon.observe(0.0, 150)        # 150 <= 1 * 2 * 100 * 1
        assert not mon.observe(0.0, 500)    # 650 > 200: loss never grew
        assert mon.observe(10.0, 0)         # the bound catches up
        assert mon.violation_round == 1 and not mon.ok
    s = mons[0].series()
    assert s.ratio[1] > 1.0 and s.ratio[0] <= 1.0 and not s.ok
    np.testing.assert_array_equal(s.ratio, mons[1].series().ratio)
    tr, jtr = TTracer(), JTracer()
    mons[0].emit(tr)
    mons[1].emit(jtr)
    names = [e["name"] for e in tr.events]
    assert names.count("criterion/bytes") == mons[0].rounds
    assert names.count("criterion/loss") == mons[0].rounds
    assert names.count("criterion/violation") == 1
    assert tr.to_json() == jtr.to_json()


def test_monitor_validates_and_refuses_a_second_result():
    with pytest.raises(ValueError):
        tmon.CriterionMonitor(m=0, unit_bytes=1)
    with pytest.raises(ValueError):
        tmon.CriterionMonitor(m=1, unit_bytes=0)
    with pytest.raises(ValueError):
        tmon.CriterionMonitor(m=1, unit_bytes=1, slack=0.0)
    _, tl = _learners("linear")
    res = teng.run(tl, TProtocol(kind="periodic", period=5), X, Y,
                   device="cpu")
    mon = tmon.monitor_result(res, tl, M)
    with pytest.raises(ValueError, match="fresh"):
        mon.observe_result(res)
    # the same run fed round by round: the same integer bytes
    inc = tmon.CriterionMonitor.for_substrate(tl, M)
    for t in range(T):
        inc.observe(0.0, int(np.diff(res.cumulative_bytes, prepend=0)[t]))
    np.testing.assert_array_equal(inc.series().cumulative_bytes,
                                  res.cumulative_bytes)
