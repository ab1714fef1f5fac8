"""The port's mesh engine (``launch.mesh``, ``engine.run(mesh=)``,
``engine.sweep(mesh=)``, ``run_population(mesh=)``, the serving
engine's home-shard routing) on CPU shards.

The size is tests/test_engine_mesh.py's (T 40, m 8, d 6, SV budget 12,
RFF D 32).  The contract:

- against the port's single-device run, at 1, 2 and 4 shards on the
  CPU (``make_learner_mesh(devices=["cpu"] * n)``): every field
  bitwise — losses, errors, bytes, sync rounds, divergences, epsilons;
- against the JAX package's single-device engine (its own mesh path is
  not bitwise on this tree: tests/test_engine_mesh.py fails there):
  sync rounds, sync counts and bytes equal, floats within the suite's
  parity pair; each dynamic delta lies clear of every distance the
  port checks by more than that pair, so no decision can flip on
  rounding;
- ``Substrate.dist_to_ref_each`` against the JAX package's, and bitwise
  ``dist_to_ref`` on a stack of equal reference slices.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.core import engine as jeng
from repro.core import rff as jrff
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.core.substrate import substrate_of as jsubstrate_of
from repro.data.streams import susy_stream
from repro.population import PopulationSpec as JPopSpec
from repro.population import participation_masks as jmasks
from repro.population import run_population as jrun_population
from repro.serving import KernelServingEngine as JEngine

from repro_torch import convert
from repro_torch import population as tpop
from repro_torch.core import engine as teng
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import make_kernel_serving_engine
from repro_torch.serving import KernelServingEngine as TEngine

T, M, D = 40, 8, 6          # tests/test_engine_mesh.py:43
SHARDS = (1, 2, 4)
FIELDS = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
          "sync_rounds", "divergences", "eps_history")
_JRFF = JRFFSpec(dim=D, num_features=32, gamma=0.3, seed=0)
#: each family's dynamic delta: clear of every distance its run checks
DELTAS = {"sv": 1.0, "rff": 0.9, "linear": 1.0}


def _learners(family, budget=12):
    """(reference learner, port learner): tests/test_engine_mesh.py's."""
    if family == "sv":
        common = dict(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                      budget=budget, dim=D)
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **common))
    if family == "rff":
        W, b = jrff.rff_params(_JRFF)
        return _JRFF, convert.rff_spec(_JRFF, W, b)
    common = dict(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001, dim=D)
    return JLearner(**common), TLearner(**common)


def _proto(family, kind):
    if kind == "dynamic":
        return dict(kind="dynamic", delta=DELTAS[family])
    if kind == "periodic":
        return dict(kind="periodic", period=7)
    return dict(kind="continuous")


def _cpu_mesh(n):
    return tmesh.make_learner_mesh(devices=["cpu"] * n)


def _assert_bitwise(a, b, tag):
    for field in FIELDS:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), \
            (tag, field, x, y)
    assert a.num_syncs == b.num_syncs and a.total_bytes == b.total_bytes, tag


def _assert_reference(got, want, tag):
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds, tag)
    assert got.num_syncs == want.num_syncs, tag
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes,
                                  tag)
    for field in ("cumulative_loss", "divergences", "eps_history"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=f"{tag} {field}")


def _recording(sub, dists):
    """``sub`` with every distance its dynamic check computes logged."""
    base = type(sub)

    class Recording(base):
        def dist_to_ref(self, models, ref):
            d = base.dist_to_ref(self, models, ref)
            dists.append(d.detach().cpu().numpy())
            return d

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


def _assert_clear(dists, delta):
    assert dists, "no check round ran"
    d = np.concatenate(dists)
    margin = float(np.min(np.abs(d - delta)))
    assert margin > PARITY_ATOL + PARITY_RTOL * max(delta, d.max()), \
        f"delta {delta} lies within the tolerance of a distance ({margin})"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_learner_mesh_and_its_refusals():
    """``make_learner_mesh`` places shards as asked, is hashable, and the
    engine refuses what the reference's ``_resolve_mesh`` refuses."""
    mesh = _cpu_mesh(4)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.shape == {"learners": 4} and mesh.size == 4
    assert hash(mesh) == hash(_cpu_mesh(4)) and mesh == _cpu_mesh(4)
    assert tmesh.learner_axes_of(mesh) == ("learners",)
    assert tmesh.data_axes(mesh) == ("learners",)
    assert tmesh.num_learners(mesh) == 4
    other = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 2, "model": 3})
    assert tmesh.learner_axes_of(other) == ("data",)
    assert tmesh.num_learners(other) == 2
    with pytest.raises(ValueError, match="learner axis"):
        tmesh.learner_axes_of(types.SimpleNamespace(axis_names=("model",)))
    with pytest.raises(ValueError):
        tmesh.make_learner_mesh(3, devices=["cpu"] * 2)

    X, Y = susy_stream(4, 6, d=D, seed=0)
    _, tl = _learners("linear")
    p = TProtocol(kind="periodic", period=2)
    with pytest.raises(ValueError, match="evenly"):      # 6 over 4 shards
        teng.run(tl, p, X, Y, mesh=mesh)
    with pytest.raises(ValueError, match="evenly"):
        teng.sweep(tl, [p], X, Y, mesh=mesh)
    with pytest.raises(TypeError, match="LearnerMesh"):
        teng.run(tl, p, X, Y, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_learner_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_learner_mesh(devices=["cuda:0"] * 2)
    # a device= other than the mesh's lead is refused (here, without a
    # card, already as a device that does not exist)
    with pytest.raises((ValueError, RuntimeError)):
        teng.run(tl, p, X[:, :4], Y[:, :4], mesh=mesh, device="cuda")
    # device= that agrees with the mesh's lead is taken
    teng.run(tl, p, X[:, :4], Y[:, :4], mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# engine.run(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["coordinator", "allreduce"])
@pytest.mark.parametrize("kind", ["dynamic", "periodic", "continuous"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_mesh_run_equals_single_device_and_the_reference(family, kind,
                                                         topology):
    X, Y = susy_stream(T, M, d=D, seed=3)
    jl, tl = _learners(family)
    proto = _proto(family, kind)
    kw = dict(record_divergence=True, topology=topology)
    dists: list = []
    solo = teng.run(_recording(tsub.substrate_of(tl), dists),
                    TProtocol(**proto), X, Y, device="cpu", **kw)
    assert solo.num_syncs > 0, "a run without syncs proves nothing"
    if kind == "dynamic":
        _assert_clear(dists, proto["delta"])
    ops.reset_launch_counts()
    for n in SHARDS:
        got = teng.run(tl, TProtocol(**proto), X, Y, mesh=_cpu_mesh(n), **kw)
        _assert_bitwise(got, solo, f"{family}/{kind}/{topology}/{n} shards")
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched"
    want = jeng.run(jl, JProtocol(**proto), X, Y, **kw)
    _assert_reference(solo, want, f"{family}/{kind}/{topology}")


@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_masked_mesh_run_equals_single_device_and_the_reference(family):
    """A churny population: the cohort, rejoins and rejoin bytes summed
    over the shards, the sync over the gathered stack and mask."""
    X, Y = susy_stream(T, M, d=D, seed=5)
    jl, tl = _learners(family)
    spec = tpop.PopulationSpec(m_total=M, sample_rate=0.8, seed=3)
    mask = tpop.participation_masks(spec, T)
    assert np.array_equal(mask, jmasks(JPopSpec(m_total=M, sample_rate=0.8,
                                                seed=3), T))
    assert not mask.all() and tpop.rejoin_counts(mask).sum() > 0
    proto = dict(kind="periodic", period=5)
    kw = dict(record_divergence=True, participation=mask)
    solo = teng.run(tl, TProtocol(**proto), X, Y, device="cpu", **kw)
    assert solo.num_syncs > 0
    for n in SHARDS:
        got = teng.run(tl, TProtocol(**proto), X, Y, mesh=_cpu_mesh(n), **kw)
        _assert_bitwise(got, solo, f"{family} masked/{n} shards")
    _assert_reference(solo, jeng.run(jl, JProtocol(**proto), X, Y, **kw),
                      f"{family} masked")


# ---------------------------------------------------------------------------
# sweep(mesh=) and run_population(mesh=)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_mesh_sweep_equals_single_device_and_the_reference(family):
    X, Y = susy_stream(T, M, d=D, seed=3)
    jl, tl = _learners(family)
    delta = DELTAS[family]
    grid = [dict(kind="dynamic", delta=delta),
            dict(kind="dynamic", delta=2.0 * delta, mini_batch=5),
            dict(kind="periodic", period=7), dict(kind="continuous")]
    solo = teng.sweep(tl, [TProtocol(**g) for g in grid], X, Y, device="cpu")
    for n in (2, 4):
        got = teng.sweep(tl, [TProtocol(**g) for g in grid], X, Y,
                         mesh=_cpu_mesh(n))
        for i in range(len(grid)):
            _assert_bitwise(got[i], solo[i], f"{family} sweep[{i}]/{n}")
    want = jeng.sweep(jl, [JProtocol(**g) for g in grid], X, Y)
    for i in range(len(grid)):
        _assert_reference(solo[i], want[i], f"{family} sweep[{i}]")


def test_mesh_population_equals_single_device_and_the_reference():
    X, Y = susy_stream(T, M, d=D, seed=5)
    jl, tl = _learners("linear")
    kw = dict(m_total=M, sample_rate=0.5, seed=7)
    proto = dict(kind="dynamic", delta=0.45)
    dists: list = []
    solo = tpop.run_population(tpop.PopulationSpec(**kw),
                               _recording(tsub.substrate_of(tl), dists),
                               TProtocol(**proto), X, Y, device="cpu")
    assert solo.sim.num_syncs > 0 and solo.total_rejoins > 0
    _assert_clear(dists, proto["delta"])
    for n in (2, 4):
        got = tpop.run_population(tpop.PopulationSpec(**kw), tl,
                                  TProtocol(**proto), X, Y,
                                  mesh=_cpu_mesh(n))
        _assert_bitwise(got.sim, solo.sim, f"population/{n}")
        np.testing.assert_array_equal(got.participation, solo.participation)
    want = jrun_population(JPopSpec(**kw), jl, JProtocol(**proto), X, Y)
    _assert_reference(solo.sim, want.sim, "population")
    np.testing.assert_array_equal(solo.participation, want.participation)


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------


def _serve(eng, X, Y, n_requests=40):
    rng = np.random.default_rng(0)
    for t in range(X.shape[0]):
        for i in range(X.shape[1]):
            eng.feedback(X[t, i], Y[t, i], learner=i, at=float(t + 1))
    reqs = []
    for _ in range(n_requests):
        lid = int(rng.integers(X.shape[1]))
        reqs.append(eng.submit(X[int(rng.integers(X.shape[0])), lid],
                               learner=lid, at=float(rng.uniform(0, T))))
    return eng.serve(), reqs


@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_mesh_serving_routes_home_and_equals_the_unmeshed_engine(family):
    """tests/test_serving.py's mesh script on CPU shards: the ``sim``
    and every served prediction bitwise the unmeshed engine's (the tick
    grid at zero predict cost launches at the same times either way),
    each chunk on its home shard, ``home_shard`` the reference's;
    ``make_kernel_serving_engine`` refuses ``mesh=`` and, without a
    card, its default mesh."""
    X, Y = susy_stream(T, M, d=D, seed=3)
    _, tl = _learners(family)
    pcfg = TProtocol(kind="dynamic", delta=DELTAS[family])
    base, base_reqs = _serve(TEngine(tl, pcfg, M, device="cpu"), X, Y)
    _assert_bitwise(base.sim, teng.run(tl, pcfg, X, Y, device="cpu"),
                    "unmeshed serving vs run")
    for n in (2, 4):
        eng = TEngine(tl, pcfg, M, mesh=_cpu_mesh(n))
        chunks = []
        real = eng._predict_chunk

        def spy(chunk, bucket, real=real):
            chunks.append({eng.home_shard(r.learner) for r in chunk})
            return real(chunk, bucket)

        eng.scheduler._predict_fn = spy
        res, reqs = _serve(eng, X, Y)
        assert res.num_requests == 40 and np.isfinite(res.latencies).all()
        _assert_bitwise(res.sim, base.sim, f"{family} serving/{n}")
        assert [r.yhat for r in reqs] == [r.yhat for r in base_reqs]
        assert all(len(c) == 1 for c in chunks), "a chunk mixed shards"
        assert len(eng.scheduler.pools) == n
        per = types.SimpleNamespace(_per_shard=M // n)
        assert [eng.home_shard(i) for i in range(M)] == \
            [JEngine.home_shard(per, i) for i in range(M)]
    eng1 = TEngine(tl, pcfg, M, mesh=_cpu_mesh(1))
    assert eng1.home_shard(M - 1) == 0
    # make_kernel_serving_engine owns its mesh (one shard a card)
    with pytest.raises(ValueError, match="mesh"):
        make_kernel_serving_engine(tl, pcfg, M, mesh=_cpu_mesh(1))
    with pytest.raises(ValueError, match="evenly"):
        TEngine(tl, pcfg, 6, mesh=_cpu_mesh(4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_kernel_serving_engine(tl, pcfg, M)


# ---------------------------------------------------------------------------
# Substrate.dist_to_ref_each
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,budget", [("sv", 12), ("sv", 130),
                                           ("rff", None), ("linear", None)])
def test_dist_to_ref_each_matches_the_reference_and_dist_to_ref(family,
                                                                budget):
    """On trained stacks: against the JAX package's ``dist_to_ref_each``
    (``"pallas"`` in interpret mode at the engaged budget 130, the
    port's ``"kernels"`` on the CPU), and with every reference slice
    equal, bitwise the port's ``dist_to_ref``."""
    X, Y = susy_stream(12, 4, d=D, seed=1)
    jl, tl = _learners(family, budget or 12)
    backend = "kernels" if budget == 130 else "reference"
    jsub = jsubstrate_of(jl, backend="pallas" if budget == 130
                         else "reference")
    sub = tsub.substrate_of(tl, backend=backend).on(torch.device("cpu"))
    dev = torch.device("cpu")
    step = teng.make_protocol_step(sub, "none")
    params = teng.params_of(TProtocol(kind="none"))
    carry = teng.init_protocol_carry(sub, 4, dev)
    stacks = []
    for t in range(X.shape[0]):
        carry, _ = step(params, carry, (torch.as_tensor(X[t]),
                                        torch.as_tensor(Y[t]), t))
        if t in (5, 11):
            stacks.append(sub.models_of(carry[0]))
    models, refs = stacks[1], stacks[0]      # per-learner references
    jtype = type(jsub.models_of(jsub.init(4)))

    def to_jax(tree):
        return jtype(*(jnp.asarray(v.numpy()) for v in tree))

    got = sub.dist_to_ref_each(models, refs)
    want = jsub.dist_to_ref_each(to_jax(models), to_jax(refs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    one = tsub.tree_map(lambda v: v[2], refs)
    equal = tsub.tree_map(lambda v: v[2:3].expand_as(v).clone(), refs)
    assert torch.equal(sub.dist_to_ref_each(models, equal),
                       sub.dist_to_ref(models, one)), \
        "an equal stack must give dist_to_ref's floats"
