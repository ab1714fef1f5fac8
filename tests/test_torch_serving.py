"""``repro_torch.serving`` against ``repro.serving`` on the same inputs.

The same seeded numpy streams and query traffic go through the JAX
package's ``serve_stream`` (``backend="pallas"``: the Pallas kernels in
interpret mode) and through the port's with ``device="cpu"`` (the
kernels' plain versions).  The contract of a serving run:

- protocol face (``ServeResult.sim``): sync rounds, sync count and
  bytes equal to the reference's; losses, divergences and compression
  errors within the suite's parity pair; and bitwise equal to the
  port's own ``engine.run`` on the same stream (one step function);
- serving face: latencies, queue-depth samples, bucket counts,
  launches, sheds, deferrals, sync delays, ticks and the simulated wall
  clock exactly equal: they live on the seeded event clock;
- the answers: every served request, by uid in completion order, with
  its prediction within the parity pair of the reference's;
- a traced run exports byte-identical trace JSON.

``predict_batch`` itself is held against the JAX package's
``Substrate.predict_batch`` on the same models at every bucket size.

Sizes: T = 40, m = 3, d = 6 (linear engaged: m = 130); engaged means
SV budget 130 and RFF D 256; buckets (1, 4, 16) bound the Pallas
interpret compile time.  Dynamic thresholds come from
tests/test_torch_engine.py, where they are asserted clear of every
checked distance on the same streams.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import DELTAS, D_IN, T_ROUNDS, _learners

from repro.core import substrate as jsub
from repro.core.learners import LearnerConfig as JLearner
from repro.core.learners import LinearLearnerState as JLinearState
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFLearnerState as JRFFState
from repro.core.rkhs import SVModel as JSVModel
from repro.data.streams import susy_stream
from repro.runtime import SystemConfig as JSystem
from repro.serving import KernelServingEngine as JEngine
from repro.serving import make_arrivals as jarrivals
from repro.serving import serve_stream as jserve
from repro.telemetry.trace import Tracer as JTracer

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.kernels import ops
from repro_torch.runtime import SystemConfig as TSystem
from repro_torch.runtime.clock import SystemModel as TSystemModel
from repro_torch.serving import DEFAULT_BUCKETS
from repro_torch.serving import KernelServingEngine as TEngine
from repro_torch.serving import make_arrivals as tarrivals
from repro_torch.serving import serve_stream as tserve
from repro_torch.telemetry import Tracer as TTracer

BUCKETS = (1, 4, 16)
SYS = dict(seed=0, compute_jitter=0.3, base_latency=0.05, bandwidth=1e4)
SIM_FIELDS = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
              "sync_rounds", "eps_history", "divergences")
SERVING_FIELDS = ("latencies", "queue_depth", "sync_delays")
SERVING_SCALARS = ("bucket_counts", "launches", "num_shed", "num_deferred",
                   "ticks", "wall_clock", "rounds", "policy", "slots")


JMODELS = {"sv": JSVModel, "rff": JRFFState, "linear": JLinearState}


@pytest.fixture
def served(monkeypatch):
    """Every serving engine (the reference's or the port's) whose
    ``serve`` runs, in call order."""
    engines = []
    for cls in (JEngine, TEngine):
        def serve(self, tenant=0, _real=cls.serve):
            engines.append(self)
            return _real(self, tenant)
        monkeypatch.setattr(cls, "serve", serve)
    return engines


def _answers(eng, tenant=0):
    """(uids, predictions) of a tenant's served requests, completion
    order."""
    reqs = eng._tenants[tenant].served
    return (np.asarray([r.uid for r in reqs], np.int64),
            np.asarray([r.yhat for r in reqs], np.float64))


def _assert_answers(got_eng, want_eng, backend_parity, tenant=0):
    (gu, gy), (wu, wy) = _answers(got_eng, tenant), _answers(want_eng, tenant)
    np.testing.assert_array_equal(gu, wu)
    assert len(gy) and np.all(np.isfinite(gy))
    backend_parity(gy, wy, "predictions")


def _proto(kind, family, size):
    if kind == "periodic":
        return dict(kind="periodic", period=7)
    return dict(kind="dynamic", delta=DELTAS[family, size], mini_batch=3)


def _serve_both(jl, tl, proto, X, Y, *, arrivals=("poisson", 6.0, 3),
                **kw):
    """(reference result, port result) of one serving run."""
    kind, rate, seed = arrivals
    kw = {"buckets": BUCKETS, **kw}
    want = jserve(jl, JProtocol(**proto), X, Y, backend="pallas",
                  arrivals=jarrivals(kind, rate=rate, seed=seed),
                  sys_cfg=JSystem(**SYS), **kw)
    ops.reset_launch_counts()
    got = tserve(tl, TProtocol(**proto), X, Y, backend="kernels",
                 device="cpu", arrivals=tarrivals(kind, rate=rate, seed=seed),
                 sys_cfg=TSystem(**SYS), **kw)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched"
    return want, got


def _assert_serving_face_equal(got, want):
    for f in SERVING_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in SERVING_SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.summary() == want.summary()


def _assert_protocol_face(got_sim, want_sim, backend_parity):
    np.testing.assert_array_equal(got_sim.sync_rounds, want_sim.sync_rounds)
    assert got_sim.num_syncs == want_sim.num_syncs
    np.testing.assert_array_equal(got_sim.cumulative_bytes,
                                  want_sim.cumulative_bytes)
    backend_parity(got_sim.cumulative_loss, want_sim.cumulative_loss, "loss")
    backend_parity(got_sim.eps_history, want_sim.eps_history, "eps")
    backend_parity(got_sim.divergences, want_sim.divergences, "divergence")


def _assert_bitwise(a, b, tag):
    for f in SIM_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and np.array_equal(x, y), (tag, f)
    assert a.num_syncs == b.num_syncs and a.total_bytes == b.total_bytes


@pytest.mark.parametrize("size", ["small", "engaged"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
@pytest.mark.parametrize("kind", ["periodic", "dynamic"])
def test_serve_stream_matches_reference(kind, family, size, backend_parity,
                                        served):
    jl, tl, m = _learners(family, size)
    proto = _proto(kind, family, size)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    want, got = _serve_both(jl, tl, proto, X, Y, policy="continuous",
                            slots=2, predict_cost=0.05, slo=0.3)
    assert got.num_requests > 0 and got.num_syncs > 0
    _assert_serving_face_equal(got, want)
    _assert_protocol_face(got.sim, want.sim, backend_parity)
    _assert_answers(served[1], served[0], backend_parity)
    # the port's serving protocol view is its engine.run's, bitwise
    run = teng.run(tl, TProtocol(**proto), X, Y, backend="kernels",
                   device="cpu")
    _assert_bitwise(got.sim, run, (kind, family, size))


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("policy", ["tick", "continuous"])
def test_policies_and_arrivals_under_shedding(policy, arrival,
                                              backend_parity, served):
    """Every policy x arrival process with a shedding queue: capacity
    is capped below the offered load (one lane, buckets of at most two,
    0.5 per launch) so admission binds."""
    jl, tl, m = _learners("linear", "small")
    proto = dict(kind="dynamic", delta=DELTAS["linear", "small"],
                 mini_batch=3)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    want, got = _serve_both(
        jl, tl, proto, X, Y, arrivals=(arrival, 6.0, 3), policy=policy,
        slots=1, predict_cost=0.5, max_queue=2, overload="shed",
        buckets=(1, 2), tick_interval=0.5)
    assert got.num_shed > 0
    _assert_serving_face_equal(got, want)
    _assert_protocol_face(got.sim, want.sim, backend_parity)
    _assert_answers(served[1], served[0], backend_parity)
    _assert_bitwise(got.sim, teng.run(tl, TProtocol(**proto), X, Y,
                                      device="cpu"), (policy, arrival))


def test_deferral_and_uniform_queries_match_reference(backend_parity,
                                                      served):
    """The deferring queue and the uniform ``queries_per_round``
    traffic, on the SV substrate."""
    jl, tl, m = _learners("sv", "small")
    proto = dict(kind="periodic", period=5)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=2)
    kw = dict(queries_per_round=3.0, query_seed=11, buckets=(1, 2),
              policy="continuous", slots=1, predict_cost=0.4, max_queue=2,
              overload="defer")
    want = jserve(jl, JProtocol(**proto), X, Y, backend="pallas",
                  sys_cfg=JSystem(**SYS), **kw)
    got = tserve(tl, TProtocol(**proto), X, Y, backend="kernels",
                 device="cpu", sys_cfg=TSystem(**SYS), **kw)
    assert got.num_deferred > 0 and got.num_shed == 0
    _assert_serving_face_equal(got, want)
    _assert_protocol_face(got.sim, want.sim, backend_parity)
    _assert_answers(served[1], served[0], backend_parity)


def _drive_tenants(Engine, Tracer, jl_or_tl, pa, pb, X, Y, **kw):
    tr = Tracer()
    eng = Engine(jl_or_tl, pa, X.shape[1], policy="continuous", slots=2,
                 predict_cost=0.05, tracer=tr, buckets=BUCKETS, **kw)
    tb = eng.add_tenant(jl_or_tl, pb)
    rng = np.random.default_rng(0)
    T, m = X.shape[:2]
    for t in range(T):
        at = float(t + 1)
        for i in range(m):
            eng.feedback(X[t, i], Y[t, i], learner=i, at=at, tenant=0)
            eng.feedback(X[t, i], Y[t, i], learner=i, at=at, tenant=tb)
        eng.submit(X[t, 0], learner=int(rng.integers(m)), at=at + 0.1,
                   tenant=0)
        eng.submit(X[t, 0], learner=int(rng.integers(m)), at=at + 0.2,
                   tenant=tb)
    eng.serve()
    return eng, tr


def test_two_tenants_each_equal_their_engine_run(backend_parity):
    jl, tl, m = _learners("linear", "small")
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    pa = dict(kind="dynamic", delta=DELTAS["linear", "small"], mini_batch=3)
    pb = dict(kind="periodic", period=3)
    jeng, jtr = _drive_tenants(JEngine, JTracer, jl, JProtocol(**pa),
                               JProtocol(**pb), X, Y)
    geng, ttr = _drive_tenants(TEngine, TTracer, tl, TProtocol(**pa),
                               TProtocol(**pb), X, Y, device="cpu")
    for tid, (g, w, p) in enumerate(zip(geng.results(), jeng.results(),
                                        (pa, pb))):
        _assert_bitwise(g.sim, teng.run(tl, TProtocol(**p), X, Y,
                                        device="cpu"), p["kind"])
        _assert_protocol_face(g.sim, w.sim, backend_parity)
        _assert_serving_face_equal(g, w)
        _assert_answers(geng, jeng, backend_parity, tenant=tid)
        assert g.num_requests == T_ROUNDS
    assert ttr.to_json() == jtr.to_json()


def test_traced_run_exports_identical_trace_json():
    """A traced SV dynamic run with a shedding continuous queue: every
    span, instant and counter — requests, buckets, rounds with their
    bytes, sync transfers, sheds — serializes to the reference's bytes."""
    jl, tl, m = _learners("sv", "engaged")
    proto = dict(kind="dynamic", delta=DELTAS["sv", "engaged"], mini_batch=3)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    jtr, ttr = JTracer(), TTracer()
    kw = dict(policy="continuous", slots=1, predict_cost=0.2, max_queue=3,
              overload="shed", buckets=BUCKETS)
    jserve(jl, JProtocol(**proto), X, Y, backend="pallas", tracer=jtr,
           arrivals=jarrivals("bursty", rate=8.0, seed=1),
           sys_cfg=JSystem(**SYS), **kw)
    got = tserve(tl, TProtocol(**proto), X, Y, backend="kernels",
                 device="cpu", tracer=ttr,
                 arrivals=tarrivals("bursty", rate=8.0, seed=1),
                 sys_cfg=TSystem(**SYS), **kw)
    assert got.num_shed > 0 and got.num_syncs > 0
    names = {e["name"] for e in ttr.events}
    assert {"shed", "round", "sync/transfer", "request"} <= names
    assert ttr.to_json() == jtr.to_json()


def _trained(sub, X, Y, kind="periodic"):
    """The learners' models after the stream, their last sync rounds
    behind them (period 7, T = 40), so they differ."""
    step = teng.make_protocol_step(sub, kind)
    params = teng.params_of(TProtocol(kind=kind, period=7))
    carry = teng.init_protocol_carry(sub, X.shape[1], torch.device("cpu"))
    for t in range(X.shape[0]):
        carry, _ = step(params, carry, (torch.as_tensor(X[t]),
                                        torch.as_tensor(Y[t]), t))
    return sub.models_of(carry[0])


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("size", ["small", "engaged"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_predict_batch_rows_equal_predict_one(family, size, backend):
    """Row i of a padded bucket is ``predict_one(models[lids[i]],
    Xb[i])`` bitwise, at every bucket size."""
    _, tl, m = _learners(family, size)
    sub = tsub.substrate_of(tl, backend=backend).on(torch.device("cpu"))
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=6)
    models = _trained(sub, X, Y)
    rng = np.random.default_rng(0)
    for bucket in (1, 2, 4, 8, 16, 32, 64):
        n = max(1, bucket - 3)
        lids = rng.integers(0, m, bucket)
        lids[n:] = lids[0]
        Xb = X[rng.integers(0, T_ROUNDS, bucket), rng.integers(0, m, bucket)]
        Xb[n:] = 0.0
        batched = sub.predict_batch(models, torch.as_tensor(lids),
                                    torch.as_tensor(Xb))
        for i in range(n):
            one = sub.predict_one(
                type(models)(*(v[lids[i]] for v in models)),
                torch.as_tensor(Xb[i]))
            assert torch.equal(batched[i], one), (bucket, i)


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("size", ["small", "engaged"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_predict_batch_matches_reference(family, size, backend,
                                         backend_parity):
    """The port's ``predict_batch`` against the JAX package's on the
    same models, at every bucket size: the gather, the kernel or plain
    prediction and the bias of each row (the reference's kernels run in
    interpret mode under ``"pallas"``)."""
    jl, tl, m = _learners(family, size)
    sub = tsub.substrate_of(tl, backend=backend).on(torch.device("cpu"))
    ref = jsub.substrate_of(
        jl, backend="pallas" if backend == "kernels" else backend)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=6)
    models = _trained(sub, X, Y)
    assert not torch.equal(models[0][0], models[0][1]), "learners alike"
    jmodels = JMODELS[family](*(jnp.asarray(v)
                                for v in convert.to_numpy(models)))
    rng = np.random.default_rng(1)
    for bucket in DEFAULT_BUCKETS:
        lids = rng.integers(0, m, bucket).astype(np.int32)
        Xb = X[rng.integers(0, T_ROUNDS, bucket), rng.integers(0, m, bucket)]
        got = sub.predict_batch(models, torch.as_tensor(lids),
                                torch.as_tensor(Xb)).numpy()
        want = np.asarray(ref.predict_batch(jmodels, jnp.asarray(lids),
                                            jnp.asarray(Xb)))
        assert got.shape == (bucket,) and np.all(np.isfinite(got))
        assert np.ptp(got) > 0 or bucket == 1, "rows all alike"
        backend_parity(got, want, f"bucket {bucket}")


def test_arrivals_and_system_model_are_the_reference_draws():
    for kind in ("poisson", "bursty", "diurnal"):
        a = tarrivals(kind, rate=5.0, seed=4).times(50.0)
        b = jarrivals(kind, rate=5.0, seed=4).times(50.0)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), kind
    from repro.runtime.clock import SystemModel as JSystemModel
    cfg = dict(seed=3, compute_jitter=0.3, straggler_frac=0.25,
               straggler_prob=0.5, base_latency=0.1, latency_jitter=0.2,
               bandwidth=1e5, drop_prob=0.1)
    ts, js = TSystemModel(TSystem(**cfg), 8), JSystemModel(JSystem(**cfg), 8)
    assert ts.draw_compute(30).tobytes() == js.draw_compute(30).tobytes()
    assert [ts.draw_latency(n) for n in (0, 10, 10**6)] == \
        [js.draw_latency(n) for n in (0, 10, 10**6)]
    assert [ts.drop() for _ in range(20)] == [js.drop() for _ in range(20)]


def test_empty_and_single_request_summaries_match_reference():
    pcfg = dict(kind="dynamic", delta=0.1)
    lin = dict(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001, dim=D_IN)
    out = []
    for Engine, L, P, kw in ((JEngine, JLearner, JProtocol, {}),
                             (TEngine, TLearner, TProtocol,
                              {"device": "cpu"})):
        empty = Engine(L(**lin), P(**pcfg), 4, **kw).serve()
        eng = Engine(L(**lin), P(**pcfg), 4, tick_interval=1.0, **kw)
        eng.submit(np.zeros(D_IN), learner=0, at=0.25)
        out.append((empty.summary(), eng.serve().summary()))
    assert out[0] == out[1]
    assert all(np.isfinite(v) for s in out[1] for v in s.values())


def test_ingress_validation_raises_where_the_reference_raises():
    lin = dict(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001, dim=D_IN)
    pcfg = dict(kind="dynamic", delta=0.1)
    for Engine, L, P, kw in ((JEngine, JLearner, JProtocol, {}),
                             (TEngine, TLearner, TProtocol,
                              {"device": "cpu"})):
        eng = Engine(L(**lin), P(**pcfg), 4, **kw)
        with pytest.raises(ValueError):
            eng.submit(np.zeros(D_IN + 1), learner=0)      # wrong dim
        with pytest.raises(ValueError):
            eng.submit(np.zeros(D_IN), learner=4)          # no such learner
        with pytest.raises(ValueError):
            eng.submit(np.zeros(D_IN), learner=0, tenant=1)  # no tenant
        with pytest.raises(ValueError):
            eng.feedback(np.zeros(D_IN), 1.0, learner=0, at=-1.0)  # past
        with pytest.raises(ValueError):                    # tenant's d
            eng.add_tenant(L(**{**lin, "dim": D_IN + 1}), P(**pcfg))
        for bad in (dict(tick_interval=0.0), dict(buckets=()),
                    dict(predict_cost=-1.0), dict(policy="lifo"),
                    dict(overload="drop"), dict(max_queue=0),
                    dict(slo=0.0), dict(slots=0)):
            with pytest.raises(ValueError):
                Engine(L(**lin), P(**pcfg), 4, **bad, **kw)
        with pytest.raises(ValueError):
            Engine(L(**lin), P(**pcfg), 0, **kw)


def test_mesh_and_default_device_are_refused_as_documented():
    lin = TLearner(algo="linear_sgd", dim=D_IN)
    pcfg = TProtocol(kind="periodic", period=2)
    # a mesh must be a launch.mesh.LearnerMesh
    with pytest.raises(TypeError, match="LearnerMesh"):
        TEngine(lin, pcfg, 2, mesh=object(), device="cpu")
    X, Y = susy_stream(4, 2, d=D_IN, seed=0)
    with pytest.raises(TypeError, match="LearnerMesh"):
        tserve(lin, pcfg, X, Y, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve(lin, pcfg, X, Y)
