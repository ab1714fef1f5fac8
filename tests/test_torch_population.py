"""The port's participation mask (``engine.run(participation=)``, the
masked substrate faces, the masked device ledger) and ``population/``,
against the JAX package's, mirroring tests/test_population.py.

- An all-True mask reproduces the port's unmasked ``run`` bitwise for
  {dynamic, periodic} x {SV, RFF, linear} (and through
  ``run_population``'s override on a churny spec).
- A partial mask against JAX's masked ``engine.run`` on the same
  inputs: sync rounds, sync counts and bytes equal, floats within the
  parity pair, every checked distance clear of delta.
- The masked sync bytes and the rejoin bytes against the pure-Python
  set-algebra oracle and against JAX's device ledger; end to end, a
  primal run's byte column against the closed-form Sec. 3 oracle.
- Empty and idle cohorts: nothing divides by zero, syncs, moves bytes
  or accrues loss.
- Masks, class assignment, rejoin counts and ``trace_population``
  byte-identical to the JAX package's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro import population as jpop
from repro.core import accounting as jacc
from repro.core import engine as jeng
from repro.core import rff as jrff
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.core.substrate import substrate_of as jsubstrate_of
from repro.data import separable_stream, susy_stream
from repro.telemetry.trace import Tracer as JTracer

from repro_torch import convert
from repro_torch import population as tpop
from repro_torch.core import accounting as tacc
from repro_torch.core import engine as teng
from repro_torch.core import rkhs as trkhs
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.telemetry import Tracer as TTracer
from repro_torch.telemetry.monitor import monitor_population

T, M, D = 40, 6, 6
SV_KW = dict(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01, budget=8,
             dim=D)
LIN_KW = dict(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001, dim=D)
_JRFF = JRFFSpec(dim=D, num_features=16, gamma=0.3, seed=0)


def _learners(name):
    """(reference learner, port learner): tests/test_population.py's."""
    if name == "sv":
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **SV_KW),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **SV_KW))
    if name == "rff":
        W, b = jrff.rff_params(_JRFF)
        return _JRFF, convert.rff_spec(_JRFF, W, b)
    return JLearner(**LIN_KW), TLearner(**LIN_KW)


NAMES = ("sv", "rff", "linear")
PROTOS = {"dynamic": dict(kind="dynamic", delta=1.0),
          "periodic": dict(kind="periodic", period=7)}
FULL_SPEC = tpop.PopulationSpec(m_total=M, classes=((tpop.ALWAYS_ON, 1.0),))
FIELDS = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
          "sync_rounds", "divergences", "eps_history")


def _stream(seed=3):
    return susy_stream(T=T, m=M, d=D, seed=seed)


def _assert_bit_identical(a, b, tag=""):
    for field in FIELDS:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.tobytes() == y.tobytes(), (tag, field, x, y)
    assert a.num_syncs == b.num_syncs, tag
    assert a.total_bytes == b.total_bytes, tag


# ---------------------------------------------------------------------------
# an all-True mask is the unmasked run, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", PROTOS)
@pytest.mark.parametrize("name", NAMES)
def test_full_participation_bitwise_identical(name, proto):
    X, Y = _stream()
    _, learner = _learners(name)
    pcfg = TProtocol(**PROTOS[proto])
    oracle = teng.run(learner, pcfg, X, Y, record_divergence=True,
                      device="cpu")
    pres = tpop.run_population(FULL_SPEC, learner, pcfg, X, Y,
                               record_divergence=True, device="cpu")
    assert oracle.num_syncs > 0, "degenerate run proves nothing"
    assert pres.participation.all() and pres.total_rejoins == 0
    _assert_bit_identical(oracle, pres.sim, f"{name}/{proto}")
    masked = teng.run(learner, pcfg, X, Y, record_divergence=True,
                      participation=np.ones((T, M), bool), device="cpu")
    _assert_bit_identical(oracle, masked, f"{name}/{proto} override")


def test_all_true_override_on_a_churny_spec_is_the_oracle():
    X, Y = _stream(seed=5)
    _, lcfg = _learners("linear")
    pcfg = TProtocol(**PROTOS["dynamic"])
    oracle = teng.run(lcfg, pcfg, X, Y, device="cpu")
    pres = tpop.run_population(tpop.PopulationSpec(m_total=M, seed=11), lcfg,
                               pcfg, X, Y, participation=np.ones((T, M), bool),
                               device="cpu")
    _assert_bit_identical(oracle, pres.sim, "override")


@pytest.mark.parametrize("name", NAMES)
def test_masked_ops_with_every_learner_are_the_unmasked_ops(name):
    """Each masked face with an all-True mask returns its unmasked twin's
    floats and integers bitwise, on a trained stack."""
    X, Y = _stream(seed=2)
    _, learner = _learners(name)
    sub = tsub.substrate_of(learner).on(torch.device("cpu"))
    state = sub.init(M, "cpu")
    for t in range(12):
        state, _, _ = sub.round_stacked(
            state, (torch.as_tensor(X[t]), torch.as_tensor(Y[t])))
    models = sub.models_of(state)
    every = torch.ones(M, dtype=torch.bool)
    (a, ea), (b, eb) = (sub.average_stacked(models),
                        sub.average_stacked_masked(models, every))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(torch.as_tensor(ea), torch.as_tensor(eb))
    ledger = sub.ledger_init(M, "cpu")
    assert int(sub.sync_payload(models, ledger)[0]) == int(
        sub.sync_payload_masked(models, every, ledger)[0])
    assert sub.allreduce_sync_bytes_masked(M) == sub.allreduce_sync_bytes(M)


# ---------------------------------------------------------------------------
# a partial mask against the JAX package's masked engine
# ---------------------------------------------------------------------------


def _recording(sub, dists):
    base = type(sub)

    class Recording(base):
        def dist_to_ref(self, models, ref):
            d = base.dist_to_ref(self, models, ref)
            dists.append(d.detach().cpu().numpy())
            return d

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


#: dynamic deltas, each clear of every distance the masked run checks
MASKED_DELTAS = {"sv": 1.0, "rff": 0.85, "linear": 0.3}


@pytest.mark.parametrize("topology", ["coordinator", "allreduce"])
@pytest.mark.parametrize("proto", ["dynamic", "periodic", "continuous"])
@pytest.mark.parametrize("name", NAMES)
def test_partial_mask_matches_reference(name, proto, topology,
                                        backend_parity):
    X, Y = _stream(seed=7)
    jl, tl = _learners(name)
    spec = dict(m_total=M, sample_rate=0.7, seed=4)
    mask = tpop.participation_masks(tpop.PopulationSpec(**spec), T)
    assert not mask.all() and tpop.rejoin_counts(mask).sum() > 0
    p = {"dynamic": dict(kind="dynamic", delta=MASKED_DELTAS[name]),
         "periodic": PROTOS["periodic"],
         "continuous": dict(kind="continuous")}[proto]
    record = name == "sv"
    want = jeng.run(jl, JProtocol(**p), X, Y, participation=mask,
                    topology=topology, record_divergence=record)
    dists: list = []
    got = teng.run(_recording(tsub.substrate_of(tl), dists), TProtocol(**p),
                   X, Y, participation=mask, topology=topology,
                   record_divergence=record, device="cpu")
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    np.testing.assert_array_equal(got.cumulative_bytes,
                                  want.cumulative_bytes)
    assert got.num_syncs == want.num_syncs > 0
    np.testing.assert_array_equal(got.cumulative_errors,
                                  want.cumulative_errors)
    backend_parity(got.cumulative_loss, want.cumulative_loss, "loss")
    backend_parity(got.divergences, want.divergences, "divergence")
    backend_parity(got.eps_history, want.eps_history, "eps")
    if proto == "dynamic":
        d = np.concatenate(dists)
        delta = p["delta"]
        margin = float(np.min(np.abs(d - delta)))
        assert margin > PARITY_ATOL + PARITY_RTOL * max(delta, d.max()), (
            f"delta {delta} lies within the tolerance of a distance "
            f"(margin {margin}); pick another")
        assert got.num_syncs < T


def test_partial_mask_actually_changes_the_run():
    X, Y = _stream(seed=5)
    _, lcfg = _learners("linear")
    pcfg = TProtocol(**PROTOS["dynamic"])
    full = teng.run(lcfg, pcfg, X, Y, device="cpu")
    pres = tpop.run_population(
        tpop.PopulationSpec(m_total=M, sample_rate=0.6, seed=2), lcfg, pcfg,
        X, Y, device="cpu")
    assert pres.mean_cohort < M
    assert not np.array_equal(full.cumulative_loss, pres.sim.cumulative_loss)


@pytest.mark.parametrize("name", NAMES)
def test_masked_average_matches_reference(name, backend_parity):
    """The masked Prop. 2 average of a partial cohort (compressed for
    SV) against JAX's on the same stacked models."""
    X, Y = _stream(seed=6)
    jl, tl = _learners(name)
    jsub, tsb = jsubstrate_of(jl), tsub.substrate_of(tl)
    # the same trained models on both sides: the port's, converted
    state = tsb.init(M, "cpu")
    for t in range(15):
        state, _, _ = tsb.round_stacked(
            state, (torch.as_tensor(X[t]), torch.as_tensor(Y[t])))
    models = tsb.models_of(state)
    mask = np.array([True, False, True, True, False, True])
    got, geps = tsb.average_stacked_masked(models, mask)
    jmodels = type(jsub.models_of(jsub.init(M)))(
        *(jnp.asarray(v.numpy()) for v in models))
    want, weps = jsub.average_stacked_masked(jmodels, jnp.asarray(mask))
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            backend_parity(g.numpy(), np.asarray(w), name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    backend_parity(float(geps), float(weps), name)


# ---------------------------------------------------------------------------
# the masked device ledger against the set-algebra oracle and JAX's
# ---------------------------------------------------------------------------


def _random_ids(rng, m, tau, pool):
    """tests/test_population.py's stacked id generator: empty slots,
    shared ids and fresh ids."""
    ids = np.full((m, tau), -1, np.int32)
    for i in range(m):
        n_active = int(rng.integers(0, tau + 1))
        chosen = []
        for _ in range(n_active):
            if pool and rng.random() < 0.6:
                chosen.append(int(rng.choice(pool)))
            else:
                fresh = int(rng.integers(0, 100_000))
                pool.append(fresh)
                chosen.append(fresh)
        slots = rng.permutation(tau)[:n_active]
        ids[i, slots] = chosen
    return ids


def _round_mask(rng, m, t):
    """All-on, all-off, then one learner, then random cohorts."""
    if t == 0:
        return np.ones(m, bool)
    if t == 1:
        return np.zeros(m, bool)
    if t == 2:
        mask = np.zeros(m, bool)
        mask[int(rng.integers(0, m))] = True
        return mask
    return rng.random(m) < rng.random()


def _assert_masked_ledger_agrees(seed, m=4, tau=5, n_syncs=6):
    rng = np.random.default_rng(seed)
    bm, jbm = tacc.ByteModel(dim=5), jacc.ByteModel(dim=5)
    dev = tacc.device_ledger_init(m * tau)
    jdev = jacc.device_ledger_init(m * tau)
    known: set = set()
    pool: list = []
    for t in range(n_syncs):
        ids = _random_ids(rng, m, tau, pool)
        mask = _round_mask(rng, m, t)
        cohort = [ids[i] for i in np.where(mask)[0]]
        b_host, known = tacc.sync_bytes_kernel(bm, cohort, known)
        b_dev, dev = tacc.device_sync_bytes_kernel(
            bm, torch.as_tensor(ids), dev, mask=torch.as_tensor(mask))
        b_jax, jdev = jacc.device_sync_bytes_kernel(
            jbm, jnp.asarray(ids), jdev, mask=jnp.asarray(mask))
        assert int(b_dev) == b_host == int(b_jax), (t, mask)
        np.testing.assert_array_equal(dev.known.numpy(),
                                      np.asarray(jdev.known))
    known_dev = dev.known.numpy()
    assert set(known_dev[known_dev < trkhs.ID_SENTINEL].tolist()) == known


@pytest.mark.parametrize("seed", range(6))
def test_masked_sync_bytes_match_set_oracle(seed):
    _assert_masked_ledger_agrees(seed)


def test_masked_sync_bytes_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def inner(seed):
        _assert_masked_ledger_agrees(seed, m=5, tau=4, n_syncs=4)

    inner()


def _assert_rejoin_bytes_agree(seed, m=5, tau=6):
    rng = np.random.default_rng(seed)
    bm, jbm = tacc.ByteModel(dim=4), jacc.ByteModel(dim=4)
    pool: list = []
    ref = _random_ids(rng, 1, tau, pool)[0]
    ids = _random_ids(rng, m, tau, pool)
    for t in range(4):
        rejoin = _round_mask(rng, m, t)
        ref_set = set(ref[ref >= 0].tolist())
        want = sum(tacc.kernel_payload_bytes(
            bm, ref_set, set(ids[i][ids[i] >= 0].tolist()))
            for i in np.where(rejoin)[0])
        got = tacc.device_rejoin_bytes_kernel(
            bm, torch.as_tensor(ref), torch.as_tensor(ids),
            torch.as_tensor(rejoin))
        jax_b = jacc.device_rejoin_bytes_kernel(
            jbm, jnp.asarray(ref), jnp.asarray(ids), jnp.asarray(rejoin))
        assert int(got) == want == int(jax_b), (t, rejoin)


@pytest.mark.parametrize("seed", range(4))
def test_rejoin_bytes_match_payload_oracle(seed):
    _assert_rejoin_bytes_agree(seed)


def test_rejoin_bytes_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def inner(seed):
        _assert_rejoin_bytes_agree(seed)

    inner()


def test_masked_ledgers_refuse_what_the_reference_refuses():
    bm = tacc.ByteModel(dim=18)
    m, tau = 4096, 1024     # the int32 worst case
    ids = torch.full((m, tau), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tacc.device_sync_bytes_kernel(bm, ids, tacc.device_ledger_init(
            m * tau), mask=torch.ones(m, dtype=torch.bool))
    with pytest.raises(ValueError, match="int32"):
        tacc.device_rejoin_bytes_kernel(bm, ids[0], ids[:1].expand(
            60000, tau), torch.zeros(60000, dtype=torch.bool))


def _primal_oracle_bytes(res, mask, num_params, topology):
    """tests/test_population.py's closed form: every rejoiner downloads
    |theta| B; a sync moves 2 c_t |theta| B (coordinator) or
    2 (c_t - 1) |theta| B (ring total)."""
    sync_set = {int(t) for t in res.sync_rounds}
    r = tpop.rejoin_counts(mask)
    c = mask.sum(axis=1).astype(np.int64)
    per = np.zeros(mask.shape[0], np.int64)
    for t in range(mask.shape[0]):
        per[t] = int(r[t]) * num_params * 4
        if t in sync_set:
            per[t] += (2 * int(c[t]) if topology == "coordinator"
                       else 2 * max(int(c[t]) - 1, 0)) * num_params * 4
    return np.cumsum(per)


@pytest.mark.parametrize("topology", ["coordinator", "allreduce"])
@pytest.mark.parametrize("name", ["linear", "rff"])
def test_primal_bytes_match_closed_form_oracle(name, topology):
    X, Y = _stream(seed=7)
    _, learner = _learners(name)
    spec = tpop.PopulationSpec(m_total=M, sample_rate=0.7, seed=4)
    pres = tpop.run_population(spec, learner,
                               TProtocol(kind="dynamic", delta=0.3), X, Y,
                               topology=topology, device="cpu")
    assert pres.sim.num_syncs > 0 and pres.total_rejoins > 0
    want = _primal_oracle_bytes(pres.sim, pres.participation,
                                tsub.substrate_of(learner).num_params,
                                topology)
    np.testing.assert_array_equal(pres.sim.cumulative_bytes, want)


# ---------------------------------------------------------------------------
# empty and idle cohorts
# ---------------------------------------------------------------------------


def _mask_with_empty_rounds():
    mask = np.ones((T, M), bool)
    mask[5] = False                    # empty round mid-stream
    mask[6] = False                    # and a consecutive one
    mask[12, 1:] = False               # single-learner round
    mask[20:23, ::2] = False           # staggered churn
    return mask


@pytest.mark.parametrize("proto", ["dynamic", "periodic", "continuous"])
@pytest.mark.parametrize("name", NAMES)
def test_empty_cohort_rounds_are_inert(name, proto, backend_parity):
    X, Y = _stream(seed=2)
    jl, tl = _learners(name)
    p = dict(kind="continuous") if proto == "continuous" else PROTOS[proto]
    mask = _mask_with_empty_rounds()
    pres = tpop.run_population(tpop.PopulationSpec(m_total=M), tl,
                               TProtocol(**p), X, Y, participation=mask,
                               device="cpu")
    loss = pres.sim.cumulative_loss
    assert np.isfinite(loss).all(), name
    for t in (5, 6):
        assert t not in set(int(s) for s in pres.sim.sync_rounds)
        assert loss[t] == loss[t - 1], (name, proto)
        assert pres.sim.cumulative_errors[t] == \
            pres.sim.cumulative_errors[t - 1]
    assert pres.sim.cumulative_bytes[6] == pres.sim.cumulative_bytes[5]
    want = jeng.run(jl, JProtocol(**p), X, Y, participation=mask)
    np.testing.assert_array_equal(pres.sim.cumulative_bytes,
                                  want.cumulative_bytes)
    np.testing.assert_array_equal(pres.sim.sync_rounds, want.sync_rounds)
    backend_parity(loss, want.cumulative_loss, name)


@pytest.mark.parametrize("name", NAMES)
def test_fully_idle_population(name):
    X, Y = _stream(seed=2)
    _, learner = _learners(name)
    pres = tpop.run_population(tpop.PopulationSpec(m_total=M), learner,
                               TProtocol(**PROTOS["dynamic"]), X, Y,
                               participation=np.zeros((T, M), bool),
                               device="cpu")
    assert pres.sim.total_bytes == 0 and pres.sim.num_syncs == 0
    assert pres.sim.total_loss == 0.0
    assert np.isfinite(pres.sim.cumulative_loss).all()
    mon = monitor_population(pres, learner)
    assert mon.ok and mon.m == 1


@pytest.mark.parametrize("name", NAMES)
def test_average_stacked_masked_empty_cohort_is_finite(name):
    _, learner = _learners(name)
    sub = tsub.substrate_of(learner).on(torch.device("cpu"))
    models = sub.models_of(sub.init(M, "cpu"))
    avg, eps = sub.average_stacked_masked(models, np.zeros(M, bool))
    for leaf in avg:
        if leaf.dtype.is_floating_point:
            assert torch.isfinite(leaf).all(), name
    assert torch.isfinite(torch.as_tensor(eps)).all()


# ---------------------------------------------------------------------------
# masks, classes, rejoins and traces: the JAX package's, byte for byte
# ---------------------------------------------------------------------------

SPECS = [dict(m_total=64, seed=7), dict(m_total=103, seed=0),
         dict(m_total=M, sample_rate=0.8, seed=3),
         dict(m_total=500, sample_rate=0.3, seed=11,
              classes=(("always_on", 0.5), ("slow", 0.5)))]


def _specs(kw):
    """(port spec, reference spec) with the same classes."""
    classes = kw.get("classes")
    tk, jk = dict(kw), dict(kw)
    if classes is not None:
        tk["classes"] = tuple((getattr(tpop, n.upper()), f)
                              for n, f in classes)
        jk["classes"] = tuple((getattr(jpop, n.upper()), f)
                              for n, f in classes)
    return tpop.PopulationSpec(**tk), jpop.PopulationSpec(**jk)


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: f"m{kw['m_total']}")
def test_masks_classes_and_rejoins_equal_the_reference(kw):
    tspec, jspec = _specs(kw)
    mask = tpop.participation_masks(tspec, 30)
    assert mask.tobytes() == jpop.participation_masks(jspec, 30).tobytes()
    assert mask.tobytes() == tpop.participation_masks(tspec, 30).tobytes()
    ids = tpop.class_assignment(tspec)
    np.testing.assert_array_equal(ids, jpop.class_assignment(jspec))
    counts = np.bincount(ids, minlength=len(tspec.classes))
    assert counts.sum() == tspec.m_total
    for k, (_, frac) in enumerate(tspec.classes):
        assert abs(counts[k] - frac * tspec.m_total) < 1.0 + 1e-9
    np.testing.assert_array_equal(tpop.rejoin_counts(mask),
                                  jpop.rejoin_counts(mask))


def test_rejoin_counts_convention():
    mask = np.asarray([[1, 0, 0],
                       [1, 1, 0],      # learner 1 rejoins
                       [0, 1, 1],      # learner 2 rejoins
                       [1, 1, 1]],     # learner 0 rejoins
                      bool)
    np.testing.assert_array_equal(tpop.rejoin_counts(mask), [0, 1, 1, 1])


def test_stationary_on_and_validation():
    assert tpop.ALWAYS_ON.stationary_on == 1.0
    assert tpop.PHONE.stationary_on == pytest.approx(0.35 / 0.50)
    assert tpop.SLOW.speed == 0.5
    with pytest.raises(ValueError):
        tpop.AvailabilityClass("bad", p_drop=1.5)
    with pytest.raises(ValueError):
        tpop.PopulationSpec(m_total=0)
    with pytest.raises(ValueError):
        tpop.PopulationSpec(m_total=4, sample_rate=0.0)
    with pytest.raises(ValueError):
        tpop.PopulationSpec(m_total=4, classes=((tpop.ALWAYS_ON, 0.5),))
    with pytest.raises(ValueError):
        tpop.participation_masks(tpop.PopulationSpec(m_total=4), 0)


def test_run_population_validates_shapes():
    X, Y = separable_stream(T=5, m=3, d=4, seed=0)
    lcfg = TLearner(algo="linear_sgd", loss="hinge", dim=4)
    pcfg = TProtocol(**PROTOS["dynamic"])
    with pytest.raises(ValueError, match="m_total"):
        tpop.run_population(tpop.PopulationSpec(m_total=7), lcfg, pcfg, X, Y,
                            device="cpu")
    with pytest.raises(ValueError, match="participation"):
        tpop.run_population(tpop.PopulationSpec(m_total=3), lcfg, pcfg, X, Y,
                            participation=np.ones((4, 3), bool),
                            device="cpu")
    with pytest.raises(ValueError, match="participation"):
        teng.run(lcfg, pcfg, X, Y, participation=np.ones((5, 2), bool),
                 device="cpu")
    with pytest.raises(TypeError, match="LearnerMesh"):      # not a mesh
        tpop.run_population(tpop.PopulationSpec(m_total=3), lcfg, pcfg, X, Y,
                            mesh=object(), device="cpu")


def test_population_run_and_trace_equal_the_reference():
    """The same spec and stream: the port's result has JAX's ledger and
    participation, and ``trace_population`` writes JAX's JSON byte for
    byte; a rerun is bitwise."""
    X, Y = _stream(seed=5)
    kw = dict(m_total=M, sample_rate=0.8, seed=3)
    jl, tl = _learners("linear")

    def go():
        pres = tpop.run_population(tpop.PopulationSpec(**kw), tl,
                                   TProtocol(**PROTOS["dynamic"]), X, Y,
                                   device="cpu")
        tr = TTracer()
        tpop.trace_population(pres, tr)
        return pres, tr.to_json()

    p1, j1 = go()
    p2, j2 = go()
    _assert_bit_identical(p1.sim, p2.sim, "rerun")
    assert j1 == j2
    jres = jpop.run_population(jpop.PopulationSpec(**kw), jl,
                               JProtocol(**PROTOS["dynamic"]), X, Y)
    assert p1.participation.tobytes() == jres.participation.tobytes()
    np.testing.assert_array_equal(p1.sim.cumulative_bytes,
                                  jres.sim.cumulative_bytes)
    np.testing.assert_array_equal(p1.sim.sync_rounds, jres.sim.sync_rounds)
    np.testing.assert_array_equal(p1.cohort_sizes, jres.cohort_sizes)
    np.testing.assert_array_equal(p1.rejoins, jres.rejoins)
    np.testing.assert_array_equal(p1.class_ids, jres.class_ids)
    jtr = JTracer()
    jpop.trace_population(jres, jtr)
    assert j1 == jtr.to_json()
    assert p1.sim.num_syncs > 0 and p1.total_rejoins > 0


def test_monitor_population_integer_exact_and_cohort_priced():
    X, Y = _stream(seed=5)
    _, lcfg = _learners("linear")
    pres = tpop.run_population(
        tpop.PopulationSpec(m_total=M, sample_rate=0.8, seed=3), lcfg,
        TProtocol(**PROTOS["dynamic"]), X, Y, device="cpu")
    mon = monitor_population(pres, lcfg)
    assert mon.m == int(pres.cohort_sizes.max())
    series = mon.series()
    np.testing.assert_array_equal(series.cumulative_bytes,
                                  pres.sim.cumulative_bytes)
    assert series.cumulative_loss.tobytes() == np.asarray(
        pres.sim.cumulative_loss, np.float64).tobytes()
    assert mon.ok
