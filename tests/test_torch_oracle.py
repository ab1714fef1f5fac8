"""The port's serial loop oracle (``repro_torch.core.simulation``)
against the JAX package's, and the port's ``engine.run`` against it.

The cases are tests/test_engine.py:165-203's: the kernel oracle under
dynamic (two deltas), periodic, continuous and no protocol, with the
projection compression at half the budget, and the linear oracle under
dynamic, periodic and continuous.  The contract, with the reference
test's own tolerances (``_assert_matches_oracle``):

- sync rounds, sync counts, cumulative bytes and error counts equal;
- cumulative losses within rtol 1e-5 / atol 1e-4, the total loss within
  1e-5 relative; divergences and compression errors within
  rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest

from repro.core import simulation as jsim
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import separable_stream, susy_stream

from repro_torch.core import engine as teng
from repro_torch.core import simulation as tsim
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops

T, M, D = 70, 3, 6      # tests/test_engine.py:140

KERNEL_CASES = {
    "dynamic-d2.0": dict(kind="dynamic", delta=2.0),
    "dynamic-d1.0-mb4": dict(kind="dynamic", delta=1.0, mini_batch=4),
    "periodic-b9": dict(kind="periodic", period=9),
    "continuous": dict(kind="continuous"),
    "none": dict(kind="none"),
}
LINEAR_CASES = {
    "dynamic": dict(kind="dynamic", delta=1.0),
    "periodic": dict(kind="periodic", period=10),
    "continuous": dict(kind="continuous"),
}


def _kernel_cfgs(budget=12):
    common = dict(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                  budget=budget, dim=D)
    return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
            TLearner(kernel=TKernel("gaussian", gamma=0.3), **common))


def _linear_cfgs():
    common = dict(algo="linear_pa", loss="hinge", C=1.0, dim=D)
    return JLearner(**common), TLearner(**common)


def _assert_matches(want, got, check_eps=True):
    """tests/test_engine.py's ``_assert_matches_oracle``."""
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes)
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    assert got.num_syncs == want.num_syncs
    assert got.total_bytes == want.total_bytes
    np.testing.assert_allclose(got.cumulative_loss, want.cumulative_loss,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got.cumulative_errors,
                                  want.cumulative_errors)
    assert abs(got.total_loss - want.total_loss) <= \
        1e-5 * max(1.0, abs(want.total_loss))
    if len(got.divergences) and len(want.divergences):
        np.testing.assert_allclose(got.divergences, want.divergences,
                                   rtol=1e-4, atol=1e-5)
    if check_eps:
        np.testing.assert_allclose(got.eps_history, want.eps_history,
                                   rtol=1e-4, atol=1e-5)


def _oracle_cases():
    for name, proto in KERNEL_CASES.items():
        yield pytest.param("kernel", proto, {}, id=f"kernel-{name}")
    yield pytest.param("kernel", dict(kind="dynamic", delta=1.0),
                       dict(sync_budget=6, compress_method="project",
                            budget=10, T=50, seed=5),
                       id="kernel-projection-and-budget")
    for name, proto in LINEAR_CASES.items():
        yield pytest.param("linear", proto, {}, id=f"linear-{name}")


@pytest.mark.parametrize("family,proto,extra", list(_oracle_cases()))
def test_oracle_matches_the_reference_oracle_and_the_engine(family, proto,
                                                            extra):
    """The port's oracle against the JAX package's on the same stream,
    and the port's ``engine.run`` against the port's oracle."""
    extra = dict(extra)
    if family == "kernel":
        budget = extra.pop("budget", 12)
        rounds, seed = extra.pop("T", T), extra.pop("seed", 3)
        X, Y = susy_stream(T=rounds, m=M, d=D, seed=seed)
        jl, tl = _kernel_cfgs(budget)
        want = jsim.run_kernel_simulation(jl, JProtocol(**proto), X, Y,
                                          **extra)
        ops.reset_launch_counts()
        got = tsim.run_kernel_simulation(tl, TProtocol(**proto), X, Y,
                                         device="cpu", **extra)
    else:
        X, Y = separable_stream(T=T, m=M, d=D, seed=0, margin=1.0)
        jl, tl = _linear_cfgs()
        want = jsim.run_linear_simulation(jl, JProtocol(**proto), X, Y)
        ops.reset_launch_counts()
        got = tsim.run_linear_simulation(tl, TProtocol(**proto), X, Y,
                                         device="cpu")
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "the oracle launched"
    assert got.cumulative_loss.shape == (X.shape[0],)
    _assert_matches(want, got)
    if proto["kind"] not in ("none",):
        assert want.num_syncs > 0, "the case must sync"

    eng = teng.run(tl, TProtocol(**proto), X, Y, record_divergence=True,
                   device="cpu", **extra)
    _assert_matches(got, eng)
    if family == "linear":
        assert len(got.eps_history) == 0 == len(eng.eps_history)


def test_oracle_defaults_to_cuda_and_is_deterministic():
    """A repeat is bitwise; ``device=None`` means the CUDA card."""
    import torch
    X, Y = susy_stream(T=20, m=M, d=D, seed=3)
    _, tl = _kernel_cfgs()
    p = TProtocol(kind="dynamic", delta=1.0)
    a = tsim.run_kernel_simulation(tl, p, X, Y, device="cpu")
    b = tsim.run_kernel_simulation(tl, p, X, Y, device="cpu")
    for field in ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
                  "sync_rounds", "divergences", "eps_history"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsim.run_kernel_simulation(tl, p, X, Y)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsim.run_linear_simulation(_linear_cfgs()[1], p, X, Y)
