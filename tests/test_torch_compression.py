"""The SV sync's compression under ``backend="kernels"``.

``core/compression.py`` routes a sync's compression through the kernel
face once the m tau slots of the average reach the launch threshold
(128): ``truncate`` takes its one form beta^T K beta from
``ops.quadform_spec`` (no (m tau)^2 Gram), ``project`` its Gram from
``ops.gram_spec``.  On the CPU the ops run their plain versions, so
here the route is checked against the JAX package's
``repro.core.compression`` (which builds the Gram with XLA):

- epsilon within the parity pair, the compressed models equal (ids
  integer-equal, floats within the pair; against the port's own
  ``backend="reference"`` bitwise, since which slots are kept depends
  on |alpha| alone);
- ``backend="reference"`` never reaches the ops (they are replaced by
  functions that raise), ``backend="kernels"`` reaches them (counted);
- below the threshold the kernels backend keeps the plain expressions;
- an SV ``engine.run(backend="kernels")``, truncate and project, has the
  JAX package's sync rounds and bytes and its ``eps_history`` within the
  pair.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.core import engine as jeng
from repro.core import rkhs as jrkhs
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.data.streams import susy_stream

from repro_torch.core import compression as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import rkhs as trkhs
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.kernels import ops

M_LEARNERS, TAU, D_IN = 4, 32, 6      # m tau = 128: the ops engage
METHODS = ["truncate", "project"]


def _average(seed, m=M_LEARNERS, tau=TAU, d=D_IN):
    """numpy (sv, alpha, ids) of the average of m budget-tau models, some
    slots inactive (zeros, id -1): m tau slots."""
    rng = np.random.default_rng(seed)
    active = rng.random((m, tau)) < 0.85
    sv = np.where(active[..., None], rng.normal(size=(m, tau, d)),
                  0.0).astype(np.float32)
    alpha = np.where(active, rng.normal(size=(m, tau)), 0.0).astype(np.float32)
    ids = np.where(active, np.arange(m * tau).reshape(m, tau), -1)
    return sv, alpha, ids.astype(np.int32)


def _models(seed, **kw):
    sv, alpha, ids = _average(seed, **kw)
    jbar = jrkhs.average_stacked(jrkhs.SVModel(
        sv=jnp.asarray(sv), alpha=jnp.asarray(alpha), sv_id=jnp.asarray(ids)))
    tbar = trkhs.average_stacked(trkhs.SVModel(
        sv=torch.from_numpy(sv), alpha=torch.from_numpy(alpha),
        sv_id=torch.from_numpy(ids)))
    return jbar, tbar


def _spec_pair(kind):
    return (jrkhs.KernelSpec(kind, gamma=0.3),
            trkhs.KernelSpec(kind, gamma=0.3))


class _Calls:
    """Replaces ops.quadform_spec / ops.gram_spec: counts the calls and
    passes them on, or raises."""

    def __init__(self, monkeypatch, raises=False):
        self.counts = {"quadform_spec": 0, "gram_spec": 0}
        for name in self.counts:
            inner = getattr(ops, name)

            def call(*a, _name=name, _inner=inner, **k):
                if raises:
                    raise AssertionError(f"ops.{_name} reached")
                self.counts[_name] += 1
                return _inner(*a, **k)

            monkeypatch.setattr(ops, name, call)


#: (method, kind).  Not project with the linear kernel: its kept block
#: K_kk has rank at most d = 6 below the 32 kept slots, so the ridge-1e-6
#: solve returns float32 rounding noise on either side.
CASES = [("truncate", "gaussian"), ("truncate", "poly"),
         ("truncate", "linear"), ("project", "gaussian"), ("project", "poly")]


@pytest.mark.parametrize("method,kind", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_kernels_route_matches_reference(seed, method, kind, backend_parity,
                                         monkeypatch):
    js, ts = _spec_pair(kind)
    jbar, tbar = _models(seed)
    assert tbar.budget == M_LEARNERS * TAU and ops.engages(tbar.budget)
    jf, jeps = jcomp.compress(js, jbar, TAU, method)
    calls = _Calls(monkeypatch)
    tf, teps = tcomp.compress(ts, tbar, TAU, method, backend="kernels")
    route = "quadform_spec" if method == "truncate" else "gram_spec"
    assert calls.counts == {"quadform_spec": 0, "gram_spec": 0,
                            route: 1}, calls.counts
    np.testing.assert_array_equal(tf.sv_id.numpy(), np.asarray(jf.sv_id))
    backend_parity(tf.alpha.numpy(), jf.alpha, "alpha")
    backend_parity(tf.sv.numpy(), jf.sv, "sv")
    backend_parity(teps.numpy(), jeps, "eps")
    assert float(jeps) > 0.1          # something was dropped
    # the reference backend: the same model, bitwise, and eps in the pair
    rf, reps = tcomp.compress(ts, tbar, TAU, method)
    for a, b in zip(tf, rf):
        assert torch.equal(a, b)
    backend_parity(teps.numpy(), reps.numpy(), "eps vs reference backend")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("size", ["engaged", "small"])
def test_reference_backend_never_reaches_the_ops(size, method, monkeypatch):
    kw = {} if size == "engaged" else dict(m=3, tau=8)
    _, tbar = _models(2, **kw)
    _, ts = _spec_pair("gaussian")
    _Calls(monkeypatch, raises=True)
    tau = kw.get("tau", TAU)
    tcomp.compress(ts, tbar, tau, method)
    tcomp.compress(ts, tbar, tau, method, backend="reference")
    if size == "small":   # below the threshold the kernels backend too
        assert not ops.engages(tbar.budget)
        tcomp.compress(ts, tbar, tau, method, backend="kernels")


def test_unknown_backend_is_refused():
    _, tbar = _models(3)
    _, ts = _spec_pair("gaussian")
    with pytest.raises(ValueError, match="backend"):
        tcomp.compress(ts, tbar, TAU, "truncate", backend="pallas")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["periodic", "dynamic"])
def test_engine_run_eps_matches_reference(kind, method, backend_parity,
                                          monkeypatch):
    common = dict(algo="kernel_sgd", budget=TAU, dim=D_IN)
    jl = JLearner(kernel=jrkhs.KernelSpec("gaussian", gamma=0.3), **common)
    tl = TLearner(kernel=trkhs.KernelSpec("gaussian", gamma=0.3), **common)
    proto = (dict(kind="periodic", period=5) if kind == "periodic"
             else dict(kind="dynamic", delta=1.95, mini_batch=3))
    X, Y = susy_stream(30, M_LEARNERS, d=D_IN, seed=5)
    want = jeng.run(jl, JProtocol(**proto), X, Y, backend="pallas",
                    compress_method=method)
    calls = _Calls(monkeypatch)
    got = teng.run(tl, TProtocol(**proto), X, Y, backend="kernels",
                   device="cpu", compress_method=method)
    route = "quadform_spec" if method == "truncate" else "gram_spec"
    # every sync compresses (the round-0 reference too) through the ops
    assert calls.counts[route] == got.num_syncs + 1 and got.num_syncs > 0
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes)
    backend_parity(got.eps_history, want.eps_history, "eps")
    backend_parity(got.cumulative_loss, want.cumulative_loss, "loss")
    assert np.max(want.eps_history) > 0.0
