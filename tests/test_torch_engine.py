"""``repro_torch.core.engine.run`` against ``repro.core.engine.run``.

{periodic, dynamic} x {SV, RFF, linear}, each at a small size (below
the kernel threshold, where both backends run the plain expressions)
and at an engaged size (SV budget 130, RFF D 256, linear m 130), with
the matching backend on each side: ``"kernels"`` on the CPU takes the
kernels' plain versions, ``"pallas"`` runs the Pallas kernels in
interpret mode.  The contract:

- ``sync_rounds``, ``num_syncs`` and ``cumulative_bytes`` equal;
- losses, divergences and compression errors within the suite's one
  parity tolerance (``backend_parity``);
- error counts equal, unless a nonzero prediction lies within the
  tolerance of 0 (where the hinge decision may flip); the test then
  says so;
- dynamic runs use a delta clear of every checked distance by more
  than the tolerance (asserted on the port's own distances), so a sync
  decision cannot flip on rounding.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.core import engine as jeng
from repro.core import rff as jrff
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import susy_stream

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops

D_IN = 6
T_ROUNDS = 40


def _learners(family, size, **kw):
    """(reference learner, port learner, m) for one family and size."""
    if family == "sv":
        budget = 12 if size == "small" else 130
        common = {"algo": "kernel_sgd", "budget": budget, "dim": D_IN, **kw}
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **common), 3)
    if family == "rff":
        js = JRFFSpec(dim=D_IN, num_features=32 if size == "small" else 256,
                      gamma=0.3, seed=0)
        W, b = jrff.rff_params(js)
        return js, convert.rff_spec(js, W, b), 3
    common = {"algo": "linear_sgd", "dim": D_IN, **kw}
    return JLearner(**common), TLearner(**common), (3 if size == "small" else 130)


def _recording(sub, log):
    """``sub`` with its checked distances and predictions logged."""
    base = type(sub)

    class Recording(base):
        def dist_to_ref(self, models, ref):
            d = base.dist_to_ref(self, models, ref)
            log["dist"].append(d.detach().cpu().numpy().copy())
            return d

        def round_stacked(self, state, example):
            out = base.round_stacked(self, state, example)
            log["yhat"].append(out[2].detach().cpu().numpy().copy())
            return out

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


def _run_both(jl, tl, m, kind, proto, backend, backend_parity, seed=0,
              **kw):
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=seed)
    want = jeng.run(jl, JProtocol(kind=kind, **proto), X, Y,
                    backend="pallas" if backend == "kernels" else backend,
                    **kw)
    log = {"dist": [], "yhat": []}
    sub = _recording(tsub.substrate_of(tl, backend=backend), log)
    ops.reset_launch_counts()
    got = teng.run(sub, TProtocol(kind=kind, **proto), X, Y, device="cpu",
                   **kw)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched a kernel"

    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    assert got.num_syncs == want.num_syncs
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes)
    assert got.total_bytes == want.total_bytes
    backend_parity(got.cumulative_loss, want.cumulative_loss, "loss")
    backend_parity(got.eps_history, want.eps_history, "eps")
    backend_parity(got.divergences, want.divergences, "divergence")

    # an exact 0 (an empty model) is exact on both sides and cannot flip
    yhat = np.stack(log["yhat"])
    near = np.cumsum(np.sum((np.abs(yhat) <= PARITY_ATOL) & (yhat != 0),
                            axis=1))
    diff = np.abs(got.cumulative_errors - want.cumulative_errors)
    if near[-1] == 0:
        np.testing.assert_array_equal(got.cumulative_errors,
                                      want.cumulative_errors)
    else:
        warnings.warn(f"{int(near[-1])} predictions lie within atol of 0: "
                      "error counts are compared up to that many flips")
        assert np.all(diff <= near), (diff, near)

    if kind == "dynamic":
        assert log["dist"], "no check round ran"
        dist = np.concatenate(log["dist"])
        delta = proto["delta"]
        margin = float(np.min(np.abs(dist - delta)))
        assert margin > PARITY_ATOL + PARITY_RTOL * max(delta, dist.max()), (
            f"delta {delta} lies within the tolerance of a distance "
            f"(margin {margin}); pick another")
    return got, want


#: dynamic thresholds, each clear of every distance the run checks
DELTAS = {("sv", "small"): 1.95, ("sv", "engaged"): 1.95,
          ("rff", "small"): 0.6, ("rff", "engaged"): 1.8,
          ("linear", "small"): 2.7, ("linear", "engaged"): 11.5}


@pytest.mark.parametrize("size", ["small", "engaged"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
@pytest.mark.parametrize("kind", ["periodic", "dynamic"])
def test_engine_run_matches_reference(kind, family, size, backend_parity):
    jl, tl, m = _learners(family, size)
    if kind == "periodic":
        proto = dict(period=7)
    else:
        proto = dict(delta=DELTAS[family, size], mini_batch=3)
    got, want = _run_both(jl, tl, m, kind, proto, "kernels", backend_parity,
                          record_divergence=(family == "sv"
                                             and kind == "periodic"))
    assert got.num_syncs > 0
    if kind == "dynamic":       # the threshold must matter
        assert got.num_syncs < T_ROUNDS // 3


@pytest.mark.parametrize("variant", [
    "reference_backend", "allreduce", "project_half_budget", "kernel_pa",
    "squared_linear", "no_sync", "continuous",
])
def test_engine_run_variants_match_reference(variant, backend_parity):
    family, kind, proto, kw, lkw = "sv", "periodic", dict(period=5), {}, {}
    backend = "kernels"
    if variant == "reference_backend":
        backend = "reference"
    elif variant == "allreduce":
        kw = dict(topology="allreduce")
    elif variant == "project_half_budget":
        kw = dict(compress_method="project", sync_budget=6)
    elif variant == "kernel_pa":
        lkw = dict(algo="kernel_pa", loss="squared")
        kind, proto = "dynamic", dict(delta=1.05, mini_batch=4)
    elif variant == "squared_linear":
        family, lkw = "linear", dict(loss="squared", algo="linear_pa")
    elif variant == "no_sync":
        kind, proto = "none", {}
    else:
        family, kind, proto = "linear", "continuous", {}
    jl, tl, m = _learners(family, "small", **lkw)
    _run_both(jl, tl, m, kind, proto, backend, backend_parity, seed=4, **kw)


def test_engine_run_refuses_what_is_not_ported():
    """What ``run`` and ``sweep`` refuse: a ``mesh`` that is not a
    ``launch.mesh.LearnerMesh`` (TypeError; the mesh engine, which
    raised NotImplementedError here until it was ported, takes a
    LearnerMesh); ``participation=`` and ``sweep``, which raised here
    until they were ported, run: an all-True mask and a one-config
    sweep each give ``run``'s ledger."""
    X, Y = susy_stream(4, 2, d=D_IN, seed=0)
    tl = TLearner(algo="linear_sgd", dim=D_IN)
    p = TProtocol(kind="periodic", period=2)
    with pytest.raises(TypeError, match="LearnerMesh"):
        teng.run(tl, p, X, Y, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="LearnerMesh"):
        teng.sweep(tl, [p], X, Y, device="cpu", mesh=object())
    solo = teng.run(tl, p, X, Y, device="cpu")
    masked = teng.run(tl, p, X, Y, device="cpu",
                      participation=np.ones((4, 2), bool))
    row = teng.sweep(tl, [p], X, Y, device="cpu")[0]
    for got in (masked, row):
        np.testing.assert_array_equal(got.sync_rounds, solo.sync_rounds)
        np.testing.assert_array_equal(got.cumulative_bytes,
                                      solo.cumulative_bytes)
        np.testing.assert_array_equal(got.cumulative_loss,
                                      solo.cumulative_loss)
    with pytest.raises(ValueError):
        teng.run(tl, p, X, Y, device="cpu", topology="ring")
    with pytest.raises(ValueError):      # the stream's d must match
        teng.run(TLearner(algo="linear_sgd", dim=D_IN + 1), p, X, Y,
                 device="cpu")
