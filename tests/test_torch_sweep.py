"""``repro_torch.core.engine.sweep`` against ``repro.core.engine.sweep``,
and each sweep row against the port's own ``run``.

Mirrors tests/test_engine.py:268-315 and tests/test_substrate_layer.py:
160-215: a grid of mixed protocol kinds, per-config streams, a mixed
SV / RFF / linear grid and the validation errors.  Each family runs at
a small size (the plain expressions on both sides) and at an engaged
size (SV budget 130, RFF D 256, linear m 130) with the kernels backend
(its plain versions on the CPU) against the reference's ``"pallas"``
(interpret mode).  The contract:

- against the JAX package: sync rounds, sync counts and cumulative
  bytes equal; losses, divergences and compression errors within the
  suite's parity pair; dynamic deltas clear of every distance the port
  checks by more than that pair;
- against the port's ``run``: the same ledger, floats within the
  reference test's own rtol 1e-5 / atol 1e-4;
- the engaged configs of a group share ONE ``round_stacked`` call of
  n m rows a round, and the due configs' SV checks one ``quadform``
  call; below the threshold each config runs its own calls.
"""
import dataclasses

import numpy as np
import pytest

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.core import engine as jeng
from repro.core import rff as jrff
from repro.core.learners import LearnerConfig as JLearner
from repro.core.protocol import ProtocolConfig as JProtocol
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.core.substrate import RFFSubstrate as JRFFSub
from repro.core.substrate import substrate_of as jsubstrate_of
from repro.data.streams import separable_stream, susy_stream

import torch

from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.protocol import ProtocolConfig as TProtocol
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops

D_IN = 6
T_ROUNDS = 40
LEDGER = ("sync_rounds", "cumulative_bytes")
#: each family's dynamic delta at mini_batch 3 (tests/test_torch_engine.py's,
#: clear of every distance); the grid adds 1.5 x that at mini_batch 5
DELTAS = {("sv", "small"): 1.95, ("sv", "engaged"): 1.95,
          ("rff", "small"): 0.6, ("rff", "engaged"): 1.8,
          ("linear", "small"): 2.7, ("linear", "engaged"): 11.5}


def _learners(family, size):
    """(reference learner, port learner, m) for one family and size."""
    if family == "sv":
        common = dict(algo="kernel_sgd", budget=12 if size == "small" else 130,
                      dim=D_IN)
        return (JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
                TLearner(kernel=TKernel("gaussian", gamma=0.3), **common), 3)
    if family == "rff":
        js = JRFFSpec(dim=D_IN, num_features=32 if size == "small" else 256,
                      gamma=0.3, seed=0)
        W, b = jrff.rff_params(js)
        return js, convert.rff_spec(js, W, b), 3
    common = dict(algo="linear_sgd", dim=D_IN)
    return JLearner(**common), TLearner(**common), \
        (3 if size == "small" else 130)


def _grid(delta):
    """The mixed-kinds grid of tests/test_engine.py:268."""
    return [dict(kind="dynamic", delta=delta, mini_batch=3),
            dict(kind="dynamic", delta=1.5 * delta, mini_batch=5),
            dict(kind="periodic", period=7),
            dict(kind="continuous")]


class _Log:
    """What a recording substrate saw: the rows of each round call, the
    configs of each grouped check, and every distance a solo run's
    dynamic check compared with its delta."""

    def __init__(self):
        self.rounds, self.grouped, self.dists = [], [], []


def _recording(sub, log):
    base = type(sub)

    class Recording(base):
        def round_stacked(self, state, example):
            log.rounds.append(example[0].shape[0])
            return base.round_stacked(self, state, example)

        def dist_to_ref_grouped(self, models, refs):
            log.grouped.append(len(models))
            return base.dist_to_ref_grouped(self, models, refs)

        def dist_to_ref(self, models, ref):
            d = base.dist_to_ref(self, models, ref)
            log.dists.append(d.detach().cpu().numpy())
            return d

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


def _solo_runs(sub, pcfgs, X, Y, **kw):
    """The port's solo run of each config; a dynamic config's delta
    must lie clear of every distance its run checks, so that no sync
    decision can flip on rounding against the reference."""
    runs = []
    for p in pcfgs:
        log = _Log()
        runs.append(teng.run(_recording(sub, log), p, X, Y, device="cpu",
                             **kw))
        if p.kind == "dynamic":
            assert log.dists, "no check round ran"
            d = np.concatenate(log.dists)
            margin = float(np.min(np.abs(d - p.delta)))
            assert margin > PARITY_ATOL + PARITY_RTOL * max(p.delta,
                                                            d.max()), (
                f"delta {p.delta} lies within the tolerance of a distance "
                f"(margin {margin}); pick another")
    return runs


def _assert_matches_reference(got, want, backend_parity, label):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        for f in LEDGER:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f"{label}[{i}] {f}")
        assert g.num_syncs == w.num_syncs, (label, i)
        backend_parity(g.cumulative_loss, w.cumulative_loss, f"{label}[{i}]")
        backend_parity(g.divergences, w.divergences, f"{label}[{i}] div")
        backend_parity(g.eps_history, w.eps_history, f"{label}[{i}] eps")
    assert (got.eps is None) == (want.eps is None), label
    assert (got.divergences is None) == (want.divergences is None), label


def _assert_rows_match_runs(sw, runs, label):
    """Each row against the port's solo run: the same ledger, floats
    within tests/test_engine.py:290's tolerances.  A mixed grid keeps a
    series only where the reference's ``SweepResult`` does (every
    member's divergence, any member's eps), so those are compared where
    both sides have them."""
    for i, solo in enumerate(runs):
        row = sw[i]
        for f in LEDGER:
            np.testing.assert_array_equal(getattr(row, f), getattr(solo, f),
                                          err_msg=f"{label}[{i}] {f}")
        np.testing.assert_allclose(row.cumulative_loss, solo.cumulative_loss,
                                   rtol=1e-5, atol=1e-4)
        if sw.divergences is not None:
            np.testing.assert_allclose(row.divergences, solo.divergences,
                                       rtol=1e-4, atol=1e-5)
        if len(solo.eps_history):
            np.testing.assert_allclose(row.eps_history, solo.eps_history,
                                       rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("size", ["small", "engaged"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_sweep_mixed_kinds_matches_reference(family, size, backend_parity):
    jl, tl, m = _learners(family, size)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    grid = _grid(DELTAS[family, size])
    record = family == "sv"
    want = jeng.sweep(jl, [JProtocol(**p) for p in grid], X, Y,
                      backend="pallas", record_divergence=record)
    log = _Log()
    sub = _recording(tsub.substrate_of(tl, backend="kernels"), log)
    pcfgs = [TProtocol(**p) for p in grid]
    ops.reset_launch_counts()
    got = teng.sweep(sub, pcfgs, X, Y, record_divergence=record,
                     device="cpu")
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched a kernel"
    _assert_matches_reference(got, want, backend_parity, family)
    assert got[0].num_syncs > 0 and got[1].num_syncs > 0

    # stacked where the config's own shape engages, one call per config
    # below it (the stacked rows would change what a row's sums see)
    stacked = size == "engaged"
    assert sub.rows_independent(m) == stacked
    n = len(grid)
    want_rounds = [n * m] * T_ROUNDS if stacked else [m] * (n * T_ROUNDS)
    assert log.rounds == want_rounds
    assert max(log.grouped) == 2     # both dynamic configs due at t = 14

    runs = _solo_runs(tsub.substrate_of(tl, backend="kernels"), pcfgs, X, Y,
                      record_divergence=record)
    _assert_rows_match_runs(got, runs, family)


@pytest.mark.parametrize("topology", ["coordinator", "allreduce"])
def test_sweep_per_config_data_streams(topology, backend_parity):
    """tests/test_engine.py:292: one stream per config (seeds swept)."""
    common = dict(algo="linear_sgd", loss="hinge", dim=D_IN)
    grid = [dict(kind="dynamic", delta=1.7) for _ in range(3)]
    Xs, Ys = zip(*(separable_stream(T=T_ROUNDS, m=3, d=D_IN, seed=s)
                   for s in range(3)))
    X, Y = np.stack(Xs), np.stack(Ys)
    want = jeng.sweep(JLearner(**common), [JProtocol(**p) for p in grid],
                      X, Y, topology=topology)
    pcfgs = [TProtocol(**p) for p in grid]
    got = teng.sweep(TLearner(**common), pcfgs, X, Y, topology=topology,
                     device="cpu")
    _assert_matches_reference(got, want, backend_parity, "streams")
    sub = tsub.substrate_of(TLearner(**common))
    _assert_rows_match_runs(got, [
        _solo_runs(sub, [pcfgs[i]], Xs[i], Ys[i], topology=topology)[0]
        for i in range(3)], "streams")
    # seeds differ, so the runs must actually differ
    assert not np.array_equal(got[0].cumulative_loss, got[1].cumulative_loss)


@pytest.mark.parametrize("size", ["small", "engaged"])
def test_mixed_substrate_sweep(size, backend_parity):
    """tests/test_substrate_layer.py:189: SV, RFF and linear_pa configs
    in one call on the same stream, each its solo run."""
    jsv, tsv, _ = _learners("sv", size)
    jrs, trs, _ = _learners("rff", size)
    pa = dict(algo="linear_pa", loss="hinge", C=1.0, dim=D_IN)
    X, Y = susy_stream(T_ROUNDS, 3, d=D_IN, seed=4)
    grid = [dict(kind="dynamic", delta=1.7, mini_batch=3),
            dict(kind="dynamic", delta=1.8, mini_batch=3),
            dict(kind="periodic", period=8)]
    be = dict(backend="pallas")
    want = jeng.sweep([jsubstrate_of(jsv, **be), JRFFSub(spec=jrs, **be),
                       jsubstrate_of(JLearner(**pa), **be)],
                      [JProtocol(**p) for p in grid], X, Y)
    subs = [tsub.substrate_of(tsv, backend="kernels"),
            tsub.substrate_of(trs, backend="kernels"),
            tsub.substrate_of(TLearner(**pa), backend="kernels")]
    pcfgs = [TProtocol(**p) for p in grid]
    got = teng.sweep(subs, pcfgs, X, Y, device="cpu")
    assert got.eps is not None          # the SV member has an eps series
    assert got.divergences is None      # SV divergence is opt-in
    _assert_matches_reference(got, want, backend_parity, "mixed")
    _assert_rows_match_runs(got, [_solo_runs(s, [p], X, Y)[0]
                                  for s, p in zip(subs, pcfgs)], "mixed")


def test_sweep_keeps_series_as_the_reference_does():
    X, Y = susy_stream(20, 3, d=D_IN, seed=1)
    _, rff, _ = _learners("rff", "small")
    grid = [TProtocol(kind="periodic", period=5)] * 2
    sw = teng.sweep(rff, grid, X, Y, device="cpu")
    assert sw.eps is None and sw.divergences is not None
    _, sv, _ = _learners("sv", "small")
    sw = teng.sweep(sv, grid, X, Y, device="cpu")
    assert sw.eps is not None and sw.divergences is None
    sw = teng.sweep(sv, grid, X, Y, device="cpu", record_divergence=True)
    assert sw.divergences is not None and len(sw[1].divergences) == 20
    assert len(sw) == 2 and len(sw.results) == 2


def test_sweep_validates_inputs():
    _, sv, _ = _learners("sv", "small")
    X, Y = susy_stream(T=10, m=3, d=D_IN, seed=0)
    p = TProtocol(kind="dynamic")
    with pytest.raises(ValueError, match="at least one"):
        teng.sweep(sv, [], X, Y, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        teng.sweep(sv, [p], np.stack([X, X]), np.stack([Y, Y]),
                   device="cpu")
    with pytest.raises(ValueError, match="substrates"):
        teng.sweep([sv], [p, p], X, Y, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        teng.sweep(sv, [p], X, Y, topology="ring", device="cpu")
    with pytest.raises(ValueError):      # the stream's d must match
        teng.sweep(TLearner(algo="linear_sgd", dim=D_IN + 1), [p], X, Y,
                   device="cpu")
    with pytest.raises(TypeError, match="LearnerMesh"):      # not a mesh
        teng.sweep(sv, [p], X, Y, device="cpu", mesh=object())


@pytest.mark.parametrize("M,N", [(130, 130), (130, 140), (12, 12)])
def test_grouped_distances_equal_each_groups_own_call(M, N):
    """``ops.rkhs_dist_sq_groups`` gives each group the floats of its own
    ``rkhs_dist_sq`` call, bitwise, in one ``quadform`` call of
    g (2m + 1) forms where the groups' own calls are one launch each."""
    gen = torch.Generator().manual_seed(0)
    g, m, d = 3, 4, D_IN
    F = torch.randn(g, m, M, d, generator=gen)
    G = torch.randn(g, N, d, generator=gen)
    af = torch.randn(g, m, M, generator=gen)
    ag = torch.randn(g, N, generator=gen)
    af[:, :, M // 2:] = 0.0
    kw = dict(kind="gaussian", gamma=0.3)
    calls = []
    real = ops.quadform

    def counting(X, *a, **k):
        calls.append(X.shape[0])
        return real(X, *a, **k)

    ops.quadform = counting
    try:
        got = ops.rkhs_dist_sq_groups(F, G, af, ag, **kw)
    finally:
        ops.quadform = real
    for k in range(g):
        assert torch.equal(got[k], ops.rkhs_dist_sq(F[k], G[k], af[k], ag[k],
                                                    **kw)), k
    one_launch = M == N and ops.engages(M)
    assert calls == ([g * (2 * m + 1)] if one_launch else [g * m, g, g * m])
