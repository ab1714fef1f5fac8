"""``repro_torch.runtime.run_async_simulation`` against the JAX package's
(``repro.runtime``), and the port's own runtime contracts.

{periodic, dynamic} x {SV, RFF, linear} on the ideal network and on the
noisy one of tests/test_runtime.py:164-168 (stragglers, latency,
bandwidth, 5 % message loss), each at a small size (below the kernel
threshold), and SV and RFF at an engaged size (SV budget 130, RFF D 256)
with ``backend="kernels"`` on the port (its plain versions on the CPU)
and ``"pallas"`` on the reference (interpret mode).  The contract:

- ``sync_rounds``, ``num_syncs``, cumulative bytes, ``link_bytes``,
  the event clock's face (``wall_clock``, ``barrier_wall_clock``,
  ``num_dropped``, ``events_processed``) and the staleness statistics
  equal;
- losses, divergences and compression errors within the suite's one
  parity tolerance (``backend_parity``);
- error counts equal, unless a nonzero prediction lies within the
  tolerance of 0 (tests/test_torch_engine.py's rule);
- dynamic runs use a delta clear of every distance the port checks by
  more than the tolerance, so no sync decision can flip on rounding.

Then, inside the port: the zero-latency run equals ``engine.run`` in
sync rounds and bytes; a run is a pure function of its seeds; the
Def. 1 criterion holds on an async trace (tests/test_runtime.py:208),
and ``criterion.audit`` gives the reference's numbers on the same
result; a run's trace equals the reference's event for event.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.core import criterion as jcrit
from repro.core import rff as jrff
from repro.core.accounting import ByteModel as JByteModel
from repro.core.learners import LearnerConfig as JLearner
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import separable_stream, susy_stream
from repro.runtime import AsyncProtocolConfig as JAsync
from repro.runtime import SystemConfig as JSystem
from repro.runtime import run_async_simulation as jrun
from repro.telemetry.trace import Tracer as JTracer

from repro_torch import convert
from repro_torch.core import criterion as tcrit
from repro_torch.core import engine as teng
from repro_torch.core import substrate as tsub
from repro_torch.core.accounting import ByteModel as TByteModel
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.learners import gamma_of
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops
from repro_torch.runtime import AsyncProtocolConfig as TAsync
from repro_torch.runtime import SystemConfig as TSystem
from repro_torch.runtime import (run_async_kernel_simulation,
                                 run_async_linear_simulation,
                                 run_async_simulation)
from repro_torch.telemetry import Tracer as TTracer

D_IN = 6
#: the noisy network of tests/test_runtime.py:164-168
NOISY = dict(seed=3, compute_jitter=0.3, straggler_frac=0.25,
             base_latency=0.4, latency_jitter=0.5, bandwidth=1e5,
             drop_prob=0.05)
NETWORKS = {"ideal": {}, "noisy": NOISY}
#: the async protocol on each network: the zero-latency setting on the
#: ideal one, staleness-weighted windows on the noisy one
PROTOCOLS = {"ideal": dict(alpha=1.0, staleness="constant"),
             "noisy": dict(alpha=0.6, staleness="poly", agg_window=0.5)}
#: dynamic thresholds (family, size, network), each clear of every
#: distance the run checks
DELTAS = {("sv", "small", "ideal"): 1.4, ("sv", "small", "noisy"): 3.4,
          ("rff", "small", "ideal"): 1.8, ("rff", "small", "noisy"): 3.8,
          ("linear", "small", "ideal"): 5.5,
          ("linear", "small", "noisy"): 7.4,
          ("sv", "engaged", "noisy"): 1.9, ("rff", "engaged", "noisy"): 2.1}
SIZES = {"small": (120, 4), "engaged": (40, 3)}     # (T, m)
EQUAL = ("sync_rounds", "num_syncs", "cumulative_bytes", "total_bytes",
         "link_bytes", "wall_clock", "barrier_wall_clock", "num_dropped",
         "events_processed", "mean_staleness", "max_staleness")


def _learners(family, size):
    """(reference learner, port learner) for one family and size."""
    engaged = size == "engaged"
    if family == "sv":
        common = dict(algo="kernel_sgd", budget=130 if engaged else 12,
                      dim=D_IN)
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **common))
    if family == "rff":
        js = JRFFSpec(dim=D_IN, num_features=256 if engaged else 32,
                      gamma=0.3, seed=0)
        W, b = jrff.rff_params(js)
        return js, convert.rff_spec(js, W, b)
    common = dict(algo="linear_sgd", dim=D_IN)
    return JLearner(**common), TLearner(**common)


def _recording(sub, log):
    """``sub`` with every checked distance and every service prediction
    of its node rounds logged."""
    base = type(sub)

    class Recording(base):
        def dist_one(self, model, ref):
            d = base.dist_one(self, model, ref)
            log["dist"].append(float(d))
            return d

        def predict_one(self, model, x):
            yhat = base.predict_one(self, model, x)
            log["yhat"].append(float(yhat))
            return yhat

        def round_one(self, state, example):
            out = base.round_one(self, state, example)
            log["yhat"].append(float(out[2]))
            return out

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


def _assert_errors(got, want, yhat):
    """Equal error counts, unless a nonzero prediction lies within atol
    of 0 (an exact 0, an empty model, cannot flip)."""
    yhat = np.asarray(yhat)
    near = int(np.sum((np.abs(yhat) <= PARITY_ATOL) & (yhat != 0)))
    diff = np.abs(got.cumulative_errors - want.cumulative_errors)
    if near == 0:
        np.testing.assert_array_equal(got.cumulative_errors,
                                      want.cumulative_errors)
    else:
        warnings.warn(f"{near} predictions lie within atol of 0: error "
                      "counts are compared up to that many flips")
        assert np.all(diff <= near), (diff, near)


def _assert_margin(dists, delta):
    assert dists, "no check round ran"
    d = np.asarray(dists)
    margin = float(np.min(np.abs(d - delta)))
    assert margin > PARITY_ATOL + PARITY_RTOL * max(delta, d.max()), (
        f"delta {delta} lies within the tolerance of a distance "
        f"(margin {margin}); pick another")


def _run_both(family, size, kind, network, backend_parity):
    jl, tl = _learners(family, size)
    T, m = SIZES[size]
    X, Y = susy_stream(T, m, d=D_IN, seed=0)
    acfg = dict(PROTOCOLS[network], mini_batch=3)
    if kind == "dynamic":
        acfg.update(kind="dynamic", delta=DELTAS[family, size, network])
    else:
        acfg.update(kind="periodic", period=7)
    engaged = size == "engaged"
    want = jrun(jl, JAsync(**acfg), X, Y,
                sys_cfg=JSystem(**NETWORKS[network]),
                backend="pallas" if engaged else "reference")
    log = {"dist": [], "yhat": []}
    sub = _recording(tsub.substrate_of(
        tl, backend="kernels" if engaged else "reference"), log)
    ops.reset_launch_counts()
    got = run_async_simulation(sub, TAsync(**acfg), X, Y,
                               sys_cfg=TSystem(**NETWORKS[network]),
                               device="cpu")
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched a kernel"

    for field in EQUAL:
        g, w = getattr(got, field), getattr(want, field)
        assert np.array_equal(g, w), (field, g, w)
    backend_parity(got.cumulative_loss, want.cumulative_loss, "loss")
    backend_parity(got.divergences, want.divergences, "divergence")
    backend_parity(got.eps_history, want.eps_history, "eps")
    _assert_errors(got, want, log["yhat"])
    assert got.num_syncs > 0
    if kind == "dynamic":
        _assert_margin(log["dist"], acfg["delta"])
    return got, want


@pytest.mark.parametrize("network", ["ideal", "noisy"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
@pytest.mark.parametrize("kind", ["periodic", "dynamic"])
def test_async_run_matches_reference(kind, family, network, backend_parity):
    got, _ = _run_both(family, "small", kind, network, backend_parity)
    T, m = SIZES["small"]
    if kind == "dynamic":           # the threshold must matter
        assert got.num_syncs < T // 3


@pytest.mark.parametrize("family", ["sv", "rff"])
@pytest.mark.parametrize("kind", ["periodic", "dynamic"])
def test_async_run_matches_reference_engaged(kind, family, backend_parity):
    _run_both(family, "engaged", kind, "noisy", backend_parity)


@pytest.mark.parametrize("family,delta", [("sv", 2.0), ("rff", 0.45),
                                          ("linear", 2.1)])
def test_async_bytes_match_engine_at_zero_latency(family, delta,
                                                  backend_parity):
    """Ideal network, alpha = 1, constant staleness: the async dynamic
    protocol reproduces ``engine.run``'s sync rounds and byte ledger."""
    _, tl = _learners(family, "small")
    X, Y = susy_stream(150, 4, d=D_IN, seed=0)
    res_s = teng.run(tl, TProtocol(kind="dynamic", delta=delta), X, Y,
                     device="cpu")
    res_a = run_async_simulation(
        tl, TAsync(kind="dynamic", delta=delta, alpha=1.0,
                   staleness="constant"),
        X, Y, sys_cfg=TSystem(), device="cpu")
    assert res_s.num_syncs > 0
    np.testing.assert_array_equal(res_s.sync_rounds, res_a.sync_rounds)
    np.testing.assert_array_equal(res_s.cumulative_bytes,
                                  res_a.cumulative_bytes)
    assert res_s.total_bytes == res_a.total_bytes
    backend_parity(res_a.eps_history, res_s.eps_history, "eps")
    backend_parity(res_a.cumulative_loss, res_s.cumulative_loss, "loss")


def test_determinism_under_seed():
    _, tl = _learners("sv", "small")
    X, Y = susy_stream(T=120, m=4, d=D_IN, seed=1)
    acfg = TAsync(kind="dynamic", delta=2.0, alpha=0.6, staleness="poly",
                  agg_window=0.5)
    r1 = run_async_simulation(tl, acfg, X, Y, sys_cfg=TSystem(**NOISY),
                              device="cpu")
    r2 = run_async_kernel_simulation(tl, acfg, X, Y,
                                     sys_cfg=TSystem(**NOISY), device="cpu")
    for field in dataclasses.fields(r1):
        a, b = getattr(r1, field.name), getattr(r2, field.name)
        assert np.array_equal(a, b), field.name
    r3 = run_async_simulation(tl, acfg, X, Y,
                              sys_cfg=TSystem(**dict(NOISY, seed=4)),
                              device="cpu")
    assert r3.wall_clock != r1.wall_clock     # the seed actually matters


def test_criterion_on_async_trace():
    """Def. 1 on an async trace (tests/test_runtime.py:208, through the
    port's criterion): on a learnable stream the dynamic protocol stays
    loss-proportional (Prop. 6) and reaches quiescence; ``audit`` gives
    the reference's numbers on the same results."""
    T, m, d = 300, 4, 8
    X, Y = separable_stream(T=T, m=m, d=d, seed=0, margin=1.0)
    kw = dict(algo="linear_pa", loss="hinge", C=1.0, dim=d)
    tl, jl = TLearner(**kw), JLearner(**kw)
    res = run_async_linear_simulation(
        tl, TAsync(kind="dynamic", delta=1.0), X, Y, sys_cfg=TSystem(),
        record_divergence=False, device="cpu")
    ok, slack = tcrit.check_sync_bound(res, gamma_of(tl), delta=1.0)
    assert ok and slack >= 1.0
    assert tcrit.quiescent(res)
    assert res.cumulative_bytes[-1] == res.cumulative_bytes[3 * T // 4]

    want = jrun(jl, JAsync(kind="dynamic", delta=1.0), X, Y,
                sys_cfg=JSystem(), record_divergence=False)
    assert res.num_syncs == want.num_syncs
    np.testing.assert_array_equal(res.cumulative_bytes, want.cumulative_bytes)
    serial = np.cumsum(np.abs(np.sin(np.arange(m * T)))) + 1.0
    for r in (res, want):
        args = (r, serial, TByteModel(dim=d), m, 40, gamma_of(tl), 1.0)
        got = tcrit.audit(*args)
        ref = jcrit.audit(r, serial, JByteModel(dim=d), *args[3:])
        for f in dataclasses.fields(ref):
            assert np.array_equal(getattr(got, f.name),
                                  getattr(ref, f.name)), f.name
        assert tcrit.check_continuous_comm_bound(
            r.total_bytes, TByteModel(dim=d), m, T, 40) == \
            jcrit.check_continuous_comm_bound(
                r.total_bytes, JByteModel(dim=d), m, T, 40)
        assert tcrit.check_comm_bound(r, TByteModel(dim=d), m, 40, 1.0,
                                      1.0) == \
            jcrit.check_comm_bound(r, JByteModel(dim=d), m, 40, 1.0, 1.0)


def test_async_periodic_pushes_every_period_and_beats_the_barrier():
    _, tl = _learners("sv", "small")
    T, m = 60, 3
    X, Y = susy_stream(T=T, m=m, d=D_IN, seed=3)
    res = run_async_simulation(
        tl, TAsync(kind="periodic", period=10), X, Y, sys_cfg=TSystem(),
        record_divergence=False, device="cpu")
    assert res.num_syncs == T // 10
    np.testing.assert_array_equal(res.sync_rounds,
                                  np.arange(9, T, 10, dtype=np.int64))
    res = run_async_simulation(
        tl, TAsync(kind="dynamic", delta=2.0), X, Y,
        sys_cfg=TSystem(seed=0, compute_jitter=0.4, straggler_frac=0.25,
                        straggler_mult=4.0, straggler_prob=0.3),
        record_divergence=False, device="cpu")
    assert res.wall_clock < res.barrier_wall_clock
    assert res.speedup_vs_barrier > 1.0


def test_trace_matches_reference(backend_parity):
    """The port's Tracer records the reference's events: names, phases,
    lanes, simulated times and byte args equal; loss args within the
    parity pair."""
    jl, tl = _learners("sv", "small")
    X, Y = susy_stream(T=60, m=3, d=D_IN, seed=2)
    acfg = dict(kind="dynamic", delta=1.3, mini_batch=3, alpha=0.6,
                staleness="hinge", agg_window=0.5)
    jtr, ttr = JTracer(), TTracer()
    jrun(jl, JAsync(**acfg), X, Y, sys_cfg=JSystem(**NOISY), tracer=jtr,
         record_divergence=False)
    run_async_simulation(tl, TAsync(**acfg), X, Y, sys_cfg=TSystem(**NOISY),
                         tracer=ttr, record_divergence=False, device="cpu")
    assert len(ttr.events) == len(jtr.events) > 100
    losses = []
    for g, w in zip(ttr.events, jtr.events):
        g, w = dict(g), dict(w)
        ga, wa = dict(g.pop("args", {})), dict(w.pop("args", {}))
        assert g == w
        if "loss" in wa:
            losses.append((ga.pop("loss"), wa.pop("loss")))
        assert ga == wa
    assert losses
    backend_parity(*map(np.asarray, zip(*losses)), "trace loss args")
    assert {e["name"] for e in ttr.events} >= {
        "round", "msg/upload", "msg/download", "msg/report", "msg/pull",
        "sync/window", "sync/episode"}
