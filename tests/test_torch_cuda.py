"""The port's CUDA kernels on the card (``cuda`` marker).

Each test skips where ``torch.cuda.is_available()`` is false: the
kernels have no CPU mode, and on the CPU the wrappers take the plain
versions (tests/test_torch_kernels.py holds those against the JAX
reference).  This file imports no JAX, so it also runs on a machine
that has only PyTorch; there, run it without the suite's conftest
(which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The tolerance is the suite's one parity pair, restated from
tests/conftest.py:42-43 because this file may run without it; ``rff``,
whose outputs are bounded by sqrt(2/D), is held to a thousandth of
that bound instead.  ``flash`` and ``gram`` are held to the JAX
package's own kernel tolerance, rtol = atol = 2e-5 in float32
(tests/test_kernels_pallas.py); bf16 ``flash`` is the float32
kernel's result rounded once, bitwise, and within 2 bf16 ulps of the
float32 plain result rounded to bf16 wherever that ulp is above the
float32 limit (the kernel runs both products on bf16 tensor cores,
splitting into three bf16 parts what a bf16 value cannot hold); the
LM's flash prefill within 2e-2 of the largest logit, the bound of
tests/test_decode.py:37.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.learners import LearnerConfig
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.core.rff import RFFSpec
from repro_torch.core.rkhs import KernelSpec
from repro_torch.data.streams import susy_stream
from repro_torch.configs import get as get_config
from repro_torch.kernels import flash, fused, gram, ops, quadform, ref, rff
from repro_torch.models import build
from repro_torch.serving import (KernelServingEngine, make_arrivals,
                                 serve_stream)
from repro_torch.serving.lm import LMServingEngine, Request

PARITY_RTOL = 1e-3     # tests/conftest.py:42
PARITY_ATOL = 5e-3     # tests/conftest.py:43
KINDS = ["gaussian", "linear", "poly"]
EDGES = [1, 127, 128, 129, 130]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, label, rtol=PARITY_RTOL, atol=PARITY_ATOL):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=label)


def _randn(gen, *shape, dev):
    return torch.randn(*shape, generator=gen).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_sv_predict_and_quadform_match_plain(kind, cuda):
    gen = torch.Generator().manual_seed(0)
    ops.reset_launch_counts()
    for N in EDGES:
        X, SV = _randn(gen, 3, 18, dev=cuda), _randn(gen, 3, N, 18, dev=cuda)
        A = _randn(gen, 3, N, dev=cuda)
        for a in (A, torch.zeros_like(A)):
            _close(fused.sv_predict(X, SV, a, kind=kind, gamma=0.05),
                   ref.sv_predict_ref(X, SV, a, kind=kind, gamma=0.05),
                   f"sv_predict {kind} N={N}")
        Xq, Yq = _randn(gen, 2, N, 18, dev=cuda), _randn(gen, 2, 130, 18, dev=cuda)
        a, b = _randn(gen, 2, N, dev=cuda), _randn(gen, 2, 130, dev=cuda)
        _close(quadform.quadform(Xq, Yq, a, b, kind=kind, gamma=0.05),
               ref.quadform_ref(Xq, Yq, a, b, kind=kind, gamma=0.05),
               f"quadform {kind} M={N}")
    assert ops.LAUNCH_COUNTS["sv_predict"] == 2 * len(EDGES)
    assert ops.LAUNCH_COUNTS["quadform"] == len(EDGES)


@pytest.mark.cuda
@pytest.mark.parametrize("featurize", [False, True])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_primal_step_matches_plain(featurize, loss, cuda):
    gen = torch.Generator().manual_seed(1)
    for B in EDGES:
        D = 129 if featurize else 18
        args = (_randn(gen, B, 18, dev=cuda),
                torch.sign(_randn(gen, B, dev=cuda)),
                0.1 * _randn(gen, B, D, dev=cuda), _randn(gen, B, dev=cuda))
        kw = {}
        if featurize:
            kw = dict(W=_randn(gen, D, 18, dev=cuda),
                      bias=6.0 * torch.rand(D, generator=gen).to(cuda),
                      scale=float(np.sqrt(2.0 / D)))
        got = fused.primal_step(*args, loss=loss, **kw)
        want = ref.primal_step_ref(*args, loss=loss, **kw)
        for g, w, name in zip(got, want, ("w", "b", "ell", "yhat")):
            _close(g, w, f"primal_step {name} B={B}")


#: budgets and feature counts across every chunk and cluster edge of
#: the two cluster kernels (kernels/fused.py: 128 slots or 256 features
#: a block, at most 8 blocks a cluster; csrc: tiles of up to 128 slots /
#: 256 features), and the row counts at which rows must not move
SV_BUDGETS = [1, 127, 128, 129, 1023, 1024, 1025, 4096, 4097]
RFF_FEATURES = [1, 127, 129, 2048, 2049, 4096, 4097]
BATCHES = [1, 2, 3, 4, 8, 16, 32, 33, 64]


def _rff_step_args(gen, B, D, dev):
    args = (_randn(gen, B, 18, dev=dev), torch.sign(_randn(gen, B, dev=dev)),
            0.1 * _randn(gen, B, D, dev=dev), _randn(gen, B, dev=dev))
    kw = dict(W=0.3 * _randn(gen, D, 18, dev=dev),
              bias=(2 * np.pi * torch.rand(D, generator=gen)).to(dev),
              scale=float(np.sqrt(2.0 / D)))
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("N", SV_BUDGETS)
@pytest.mark.parametrize("kind", KINDS)
def test_sv_predict_cluster_edges_match_plain(kind, N, cuda):
    gen = torch.Generator().manual_seed(N)
    X, SV = _randn(gen, 5, 18, dev=cuda), _randn(gen, 5, N, 18, dev=cuda)
    A = _randn(gen, 5, N, dev=cuda)
    ops.reset_launch_counts()
    for a in (A, torch.zeros_like(A)):
        got = fused.sv_predict(X, SV, a, kind=kind, gamma=0.05)
        _close(got, ref.sv_predict_ref(X, SV, a, kind=kind, gamma=0.05),
               f"sv_predict {kind} N={N}")
        assert torch.equal(got, fused.sv_predict(X, SV, a, kind=kind,
                                                 gamma=0.05))
    assert ops.LAUNCH_COUNTS["sv_predict"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("D", RFF_FEATURES)
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_rff_step_cluster_edges_match_plain(loss, D, cuda):
    gen = torch.Generator().manual_seed(D)
    args, kw = _rff_step_args(gen, 5, D, cuda)
    ops.reset_launch_counts()
    got = fused.primal_step(*args, loss=loss, **kw)
    want = ref.primal_step_ref(*args, loss=loss, **kw)
    for g, w, name in zip(got, want, ("w", "b", "ell", "yhat")):
        _close(g, w, f"primal_step rff {name} {loss} D={D}")
    again = fused.primal_step(*args, loss=loss, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert ops.LAUNCH_COUNTS["rff_step"] == 2


def _rows_bitwise_at_every_batch(call, count_as):
    """call(B) on the first B rows: each row bitwise the 64-row call's,
    one launch counted per call."""
    full = call(max(BATCHES))
    for B in BATCHES:
        before = ops.LAUNCH_COUNTS[count_as]
        got = call(B)
        assert ops.LAUNCH_COUNTS[count_as] == before + 1
        for g, f in zip(got, full):
            assert torch.equal(g, f[:B]), B


def _off16(t):
    """A contiguous copy of t that starts 4 bytes past a 16-byte
    boundary: every block's run then has unaligned ends to stage."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    start = (4 - flat.data_ptr() // 4 % 4) % 4 + 1
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1024, 4096])
def test_sv_predict_staging_paths_agree_bitwise(N, cuda):
    """Operands whose runs start on 16-byte boundaries and copies that
    start 4 bytes past one stage differently: the same rows, bitwise."""
    gen = torch.Generator().manual_seed(5)
    X, SV = _randn(gen, 4, 18, dev=cuda), _randn(gen, 4, N, 18, dev=cuda)
    A = _randn(gen, 4, N, dev=cuda)
    assert SV.data_ptr() % 16 == 0 and A.data_ptr() % 16 == 0
    for kind in KINDS:
        got = fused.sv_predict(X, SV, A, kind=kind, gamma=0.05)
        assert torch.equal(got, fused.sv_predict(
            X, _off16(SV), _off16(A), kind=kind, gamma=0.05)), kind


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2048, 4096])
def test_rff_step_staging_paths_agree_bitwise(D, cuda):
    gen = torch.Generator().manual_seed(6)
    args, kw = _rff_step_args(gen, 4, D, cuda)
    got = fused.primal_step(*args, **kw)
    again = fused.primal_step(*args, **dict(kw, W=_off16(kw["W"])))
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
def test_cluster_kernels_refuse_a_row_too_wide_for_shared_memory(cuda):
    """The C side owns the shared-memory layout: a row wider than a
    block can stage is refused with no launch counted (the CPU path
    takes it, tests/test_torch_fused_geometry.py)."""
    z = torch.zeros
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused.sv_predict(z(1, 60000, device=cuda), z(1, 1, 60000, device=cuda),
                         z(1, 1, device=cuda))
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused.primal_step(z(1, 60000, device=cuda), z(1, device=cuda),
                          z(1, 1, device=cuda), z(1, device=cuda),
                          W=z(1, 60000, device=cuda), bias=z(1, device=cuda))
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    # the linear step stages nothing (a warp a learner): any width runs
    gen = torch.Generator().manual_seed(12)
    args = (_randn(gen, 2, 60000, dev=cuda),
            torch.sign(_randn(gen, 2, dev=cuda)),
            0.1 * _randn(gen, 2, 60000, dev=cuda), _randn(gen, 2, dev=cuda))
    for g, w, name in zip(fused.primal_step(*args), ref.primal_step_ref(*args),
                          ("w", "b", "ell", "yhat")):
        _close(g, w, f"linear step D=60000 {name}")
    assert dict(ops.LAUNCH_COUNTS) == {"linear_step": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1024, 1025])
def test_sv_predict_rows_bitwise_at_every_batch(N, cuda):
    gen = torch.Generator().manual_seed(3)
    X, SV = _randn(gen, 64, 18, dev=cuda), _randn(gen, 64, N, 18, dev=cuda)
    A = _randn(gen, 64, N, dev=cuda)
    _rows_bitwise_at_every_batch(
        lambda B: (fused.sv_predict(X[:B], SV[:B], A[:B], gamma=0.05),),
        "sv_predict")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2048, 2049])
def test_rff_step_rows_bitwise_at_every_batch(D, cuda):
    gen = torch.Generator().manual_seed(4)
    args, kw = _rff_step_args(gen, 64, D, cuda)
    _rows_bitwise_at_every_batch(
        lambda B: fused.primal_step(*(a[:B] for a in args), **kw),
        "rff_step")


#: the linear step's widths: one lane's feature, lanes idle, a warp's
#: width and its edges, many features a lane
LINEAR_D = [1, 18, 31, 32, 33, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("D", LINEAR_D)
def test_linear_step_rows_bitwise_at_every_batch(D, cuda):
    """A warp a learner, 8 learners a block: a learner's floats depend
    on D alone, so every B from 1 to 2048 gives the 2048-learner call's
    rows bitwise (the last block ragged, each learner in another warp of
    its block as B moves); the call matches the plain step."""
    gen = torch.Generator().manual_seed(20 + D)
    B = 2048
    args = (_randn(gen, B, D, dev=cuda), torch.sign(_randn(gen, B, dev=cuda)),
            0.1 * _randn(gen, B, D, dev=cuda), _randn(gen, B, dev=cuda))
    for loss in ("hinge", "squared"):
        full = fused.primal_step(*args, loss=loss)
        want = ref.primal_step_ref(*args, loss=loss)
        for g, w, name in zip(full, want, ("w", "b", "ell", "yhat")):
            _close(g, w, f"linear step D={D} {loss} {name}")
    full = fused.primal_step(*args)
    for b in range(1, B + 1):
        got = fused.primal_step(*(a[:b] for a in args))
        assert all(torch.equal(g, f[:b]) for g, f in zip(got, full)), b
    # a learner alone, from inside a block, is its row of the full call
    for i in (0, 7, 8, 1029):
        got = fused.primal_step(*(a[i:i + 1].contiguous() for a in args))
        assert all(torch.equal(g, f[i:i + 1]) for g, f in zip(got, full)), i


#: M and N across gram's 64-row and 128-column tiles and its 16-byte
#: stores (4097: neither a multiple of 4 nor of the tile); d across its
#: chunks of 32 features
GRAM_SIDES = [1, 127, 129, 130, 4097]
GRAM_D = [1, 17, 18, 31, 32, 33, 64]


def _close_dev(got, want, label, tol=2e-5):
    """|got - want| <= tol + tol |want| everywhere, on the card."""
    assert got.shape == want.shape, label
    assert bool(torch.isfinite(got).all()), label
    err = (got - want).abs()
    bad = int((err > tol + tol * want.abs()).sum())
    assert bad == 0, f"{label}: {bad} elements off, max {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", GRAM_D)
@pytest.mark.parametrize("kind", KINDS)
def test_gram_tile_edges_match_plain_and_rows_are_bitwise(kind, d, cuda):
    gen = torch.Generator().manual_seed(30 + d)
    kw = dict(kind=kind, gamma=0.05)
    ops.reset_launch_counts()
    calls = 0
    for M in GRAM_SIDES:
        for N in GRAM_SIDES:
            X, Y = _randn(gen, M, d, dev=cuda), _randn(gen, N, d, dev=cuda)
            K = gram.gram(X, Y, **kw)
            _close_dev(K, ref.gram_ref(X, Y, **kw),
                       f"gram {kind} {M}x{N} d={d}")
            calls += 1
            if M == 130:
                # a row alone is its row of the whole Gram, bitwise; a
                # repeat is bitwise
                for i in (0, 63, 64, 129):
                    assert torch.equal(gram.gram(X[i:i + 1], Y, **kw)[0], K[i])
                assert torch.equal(gram.gram(X, Y, **kw), K)
                calls += 5
    assert ops.LAUNCH_COUNTS["gram"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_engine_kernels_match_reference_and_repeat(family, cuda):
    if family == "sv":
        learner, m = LearnerConfig(budget=130, dim=18,
                                   kernel=KernelSpec(gamma=0.05)), 3
        pcfg = ProtocolConfig(kind="periodic", period=7)
    elif family == "rff":
        learner, m = RFFSpec(dim=18, num_features=256, gamma=0.05), 3
        pcfg = ProtocolConfig(kind="periodic", period=7)
    else:
        learner, m = LearnerConfig(algo="linear_sgd", dim=18), 130
        pcfg = ProtocolConfig(kind="periodic", period=7)
    X, Y = susy_stream(40, m, d=18, seed=0)
    ops.reset_launch_counts()
    got = engine.run(learner, pcfg, X, Y, backend="kernels")
    assert sum(ops.LAUNCH_COUNTS.values()) > 0
    want = engine.run(learner, pcfg, X, Y, backend="reference")
    again = engine.run(learner, pcfg, X, Y, backend="kernels")
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes)
    np.testing.assert_allclose(got.cumulative_loss, want.cumulative_loss,
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    np.testing.assert_array_equal(got.cumulative_loss, again.cumulative_loss)


#: (M, D, d, input scale): the serving shapes, the edges, and x10
#: inputs that put cos at arguments of order 10
RFF_CASES = [(64, 2048, 18, 1.0), (32, 2048, 18, 1.0), (1, 2048, 18, 1.0),
             (127, 129, 7, 1.0), (128, 128, 18, 1.0), (129, 130, 18, 1.0),
             (3, 130, 18, 1.0), (64, 2048, 18, 10.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,d,scale", RFF_CASES)
def test_rff_matches_plain_and_rows_are_independent(M, D, d, scale, cuda):
    gen = torch.Generator().manual_seed(M * 7 + D)
    X = scale * _randn(gen, M, d, dev=cuda)
    W = 0.3 * _randn(gen, D, d, dev=cuda)
    b = (2 * np.pi * torch.rand(D, generator=gen)).to(cuda)
    ops.reset_launch_counts()
    Z = rff.rff(X, W, b)
    assert ops.LAUNCH_COUNTS["rff"] == 1
    _close(Z, ref.rff_ref(X, W, b), f"rff M={M} D={D} d={d} x{scale}",
           rtol=0.0, atol=1e-3 * np.sqrt(2.0 / D))
    for i in {0, M // 2, M - 1}:
        assert torch.equal(rff.rff(X[i:i + 1], W, b)[0], Z[i]), i


#: serving's bucket sizes (serving/engine.py DEFAULT_BUCKETS), then M and
#: D across rff's 32-column and 8 R-row tiles; d inside one 32-feature
#: chunk (1, 7, 18: most of it zeros) and across two (33)
RFF_BUCKETS = [1, 2, 4, 8, 16, 32, 64]
RFF_SIDES = [1, 127, 129, 130]
RFF_D = [1, 7, 18, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("d", RFF_D)
def test_rff_buckets_and_edges_match_plain_and_rows_are_bitwise(d, cuda):
    """At every bucket size (D = 2048, a bucket the first M rows of a
    64-row X) and every (M, D) of the edges: within a thousandth of
    sqrt(2/D) of the plain version; every row bitwise the one-row call;
    a repeat bitwise; X starting 4 bytes past a 16-byte boundary
    bitwise X aligned."""
    gen = torch.Generator().manual_seed(40 + d)
    X64 = _randn(gen, max(RFF_BUCKETS), d, dev=cuda)
    shapes = [(M, 2048) for M in RFF_BUCKETS] + \
        [(M, D) for M in RFF_SIDES for D in RFF_SIDES]
    for M, D in shapes:
        X = X64[:M] if D == 2048 else _randn(gen, M, d, dev=cuda)
        W = 0.3 * _randn(gen, D, d, dev=cuda)
        b = (2 * np.pi * torch.rand(D, generator=gen)).to(cuda)
        label = f"rff M={M} D={D} d={d}"
        ops.reset_launch_counts()
        Z = rff.rff(X, W, b)
        assert ops.LAUNCH_COUNTS["rff"] == 1
        _close(Z, ref.rff_ref(X, W, b), label, rtol=0.0,
               atol=1e-3 * np.sqrt(2.0 / D))
        assert torch.equal(rff.rff(X, W, b), Z), f"{label}: a repeat"
        Xo = _off16(X)
        assert torch.equal(rff.rff(Xo, W, b), Z), f"{label}: X off 16 B"
        for i in range(M):
            assert torch.equal(rff.rff(X[i:i + 1], W, b)[0], Z[i]), \
                f"{label}: row {i}"


def _dist_3m(F, G, af, ag, **kw):
    """The 3m-form arrangement of ``ops.rkhs_dist_sq`` (one launch of
    <f_i, f_i>, m copies of <g, g>, <f_i, g>), built from
    ``ops.quadform``."""
    m, N, d = F.shape[0], G.shape[0], G.shape[1]
    Gm, agm = G.expand(m, N, d), ag.expand(m, N)
    q = ops.quadform(torch.cat([F, Gm, F]), torch.cat([F, Gm, Gm]),
                     torch.cat([af, agm, af]), torch.cat([af, agm, agm]),
                     **kw)
    return q[:m] + q[m:2 * m] - 2.0 * q[2 * m:]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_rkhs_dist_sq_is_the_3m_form_launch_bitwise(kind, m, cuda):
    """The 2m + 1 forms (<g, g> once) in one launch give the 3m-form
    launch's distances bitwise: a form's value does not depend on the
    forms beside it."""
    gen = torch.Generator().manual_seed(50 + m)
    M, d = 256, 18
    F, G = _randn(gen, m, M, d, dev=cuda), _randn(gen, M, d, dev=cuda)
    af, ag = _randn(gen, m, M, dev=cuda), _randn(gen, M, dev=cuda)
    af[:, M // 2:] = 0.0                 # padded slots
    kw = dict(kind=kind, gamma=0.05)
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    assert ops.LAUNCH_COUNTS["quadform"] == 1
    assert torch.equal(got, _dist_3m(F, G, af, ag, **kw))


@pytest.mark.cuda
def test_dist_to_ref_is_the_3m_form_launch_bitwise(cuda):
    """The SV substrate's ``dist_to_ref`` (the dynamic check) under
    ``backend="kernels"``: one launch, bitwise the 3m-form arrangement
    on the same masked coefficients."""
    from repro_torch.core import rkhs, substrate
    gen = torch.Generator().manual_seed(60)
    m, budget, d = 8, 256, 18
    sub = substrate.substrate_of(
        LearnerConfig(budget=budget, dim=d, kernel=KernelSpec(gamma=0.05)),
        backend="kernels")
    ids = torch.arange(m * budget, dtype=torch.int32).view(m, budget)
    ids[:, budget // 3:] = -1            # empty slots
    models = rkhs.SVModel(_randn(gen, m, budget, d, dev=cuda),
                          _randn(gen, m, budget, dev=cuda), ids.to(cuda))
    ref_model = rkhs.SVModel(models.sv[0] + 0.5, models.alpha[0],
                             models.sv_id[0])
    ops.reset_launch_counts()
    got = sub.dist_to_ref(models, ref_model)
    assert ops.LAUNCH_COUNTS["quadform"] == 1
    want = _dist_3m(models.sv, ref_model.sv, rkhs.masked_alpha(models),
                    rkhs.masked_alpha(ref_model), kind="gaussian",
                    gamma=0.05)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rff_serve_stream_equals_engine_run(cuda, monkeypatch):
    """A short RFF serving run launches ``rff`` for its buckets, its
    protocol view is ``engine.run``'s bitwise, and its predictions are
    the reference backend's within the parity pair."""
    learner = RFFSpec(dim=18, num_features=2048, gamma=0.05)
    pcfg = ProtocolConfig(kind="dynamic", delta=9.0, mini_batch=10)
    X, Y = susy_stream(60, 8, d=18, seed=0)
    engines = []
    real_serve = KernelServingEngine.serve
    monkeypatch.setattr(KernelServingEngine, "serve",
                        lambda self, tenant=0: engines.append(self)
                        or real_serve(self, tenant))
    kw = dict(policy="continuous", slots=2, slo=0.3, predict_cost=0.04)
    ops.reset_launch_counts()
    res = serve_stream(learner, pcfg, X, Y, backend="kernels",
                       arrivals=make_arrivals("bursty", rate=16.0, seed=0),
                       **kw)
    assert ops.LAUNCH_COUNTS["rff"] == res.launches > 0
    serve_stream(learner, pcfg, X, Y, backend="reference",
                 arrivals=make_arrivals("bursty", rate=16.0, seed=0), **kw)
    got, want = ([(r.uid, r.yhat) for r in e._tenants[0].served]
                 for e in engines)
    assert [u for u, _ in got] == [u for u, _ in want] and got
    np.testing.assert_allclose([y for _, y in got], [y for _, y in want],
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)
    run = engine.run(learner, pcfg, X, Y, backend="kernels")
    for field in ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
                  "sync_rounds", "divergences"):
        np.testing.assert_array_equal(getattr(res.sim, field),
                                      getattr(run, field), err_msg=field)


KERNEL_TOL = 2e-5      # tests/test_kernels_pallas.py

#: (BH, S, L, hd, dtype, causal, window)
FLASH_CASES = [(8, 300, 300, 128, torch.bfloat16, True, 0),
               (4, 1, 1, 128, torch.float32, True, 0),
               (4, 127, 127, 64, torch.float32, True, 0),
               (4, 129, 129, 128, torch.float32, True, 0),
               (4, 256, 256, 64, torch.float32, False, 0),
               (4, 256, 256, 64, torch.float32, True, 100),
               (4, 64, 192, 64, torch.float32, False, 0),
               (4, 129, 129, 64, torch.bfloat16, True, 0),
               # around the kernel's 64-row query and 64-key tiles, S != L
               (4, 63, 63, 64, torch.bfloat16, True, 0),
               (4, 64, 64, 128, torch.float32, True, 0),
               (4, 65, 65, 64, torch.float32, True, 0),
               (4, 65, 65, 128, torch.bfloat16, True, 0),
               (4, 63, 200, 64, torch.bfloat16, False, 0),
               (4, 200, 65, 64, torch.float32, True, 0),
               (4, 65, 130, 128, torch.bfloat16, True, 40)]


def bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |w| (w float32, already bf16)."""
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,L,hd,dtype,causal,window", FLASH_CASES)
def test_flash_matches_plain_and_repeats(BH, S, L, hd, dtype, causal,
                                         window, cuda):
    gen = torch.Generator().manual_seed(S * 31 + L + hd)
    q = _randn(gen, BH, S, hd, dev=cuda).to(dtype)
    k = _randn(gen, BH, L, hd, dev=cuda).to(dtype)
    v = _randn(gen, BH, L, hd, dev=cuda).to(dtype)
    kw = dict(causal=causal, window=window)
    ops.reset_launch_counts()
    o = flash.flash_attention(q, k, v, **kw)
    assert ops.LAUNCH_COUNTS["flash"] == 1 and o.dtype == dtype
    assert o.shape == (BH, S, hd)
    want = ref.flash_ref(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.float32:
        _close(o, want, f"flash {BH, S, L, hd}", rtol=KERNEL_TOL,
               atol=KERNEL_TOL)
    else:
        # the float32 kernel on the widened values, rounded once, is the
        # bf16 output bitwise; 2 bf16 ulps of the plain result wherever
        # that ulp is above the float32 limit (below it the plain
        # version's own float32 rounding decides the ulps)
        o32 = flash.flash_attention(q.float(), k.float(), v.float(), **kw)
        assert torch.equal(o, o32.to(dtype))
        _close(o32, want, "flash float32 kernel", rtol=KERNEL_TOL,
               atol=KERNEL_TOL)
        w16 = want.to(torch.bfloat16).float()
        assert torch.all((o.float() - w16).abs()
                         <= 2 * bf16_ulp(w16) + KERNEL_TOL)
    assert torch.equal(o, flash.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 18, 33])
@pytest.mark.parametrize("kind", KINDS)
def test_quadform_off_its_tiles_matches_plain_and_repeats(kind, d, cuda):
    """M and N off the kernel's 64-row and 128-column tiles; d = 1, one
    chunk of 32 features (18) and two (33); all-padded alpha."""
    gen = torch.Generator().manual_seed(11 + d)
    ops.reset_launch_counts()
    shapes = [(63, 65), (65, 129), (130, 127), (1, 200), (200, 1)]
    for M, N in shapes:
        X, Y = _randn(gen, 3, M, d, dev=cuda), _randn(gen, 3, N, d, dev=cuda)
        a, b = _randn(gen, 3, M, dev=cuda), _randn(gen, 3, N, dev=cuda)
        for alpha in (a, torch.zeros_like(a)):
            got = quadform.quadform(X, Y, alpha, b, kind=kind, gamma=0.05)
            _close(got, ref.quadform_ref(X, Y, alpha, b, kind=kind,
                                         gamma=0.05),
                   f"quadform {kind} M={M} N={N} d={d}")
            assert torch.equal(got, quadform.quadform(
                X, Y, alpha, b, kind=kind, gamma=0.05))
    assert ops.LAUNCH_COUNTS["quadform"] == 4 * len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_gram_matches_plain(kind, cuda):
    gen = torch.Generator().manual_seed(7)
    ops.reset_launch_counts()
    shapes = [(1, 1), (127, 129), (130, 150), (256, 384), (300, 4100)]
    for M, N in shapes:
        for d in (1, 6, 18, 40):
            X, Y = _randn(gen, M, d, dev=cuda), _randn(gen, N, d, dev=cuda)
            _close(gram.gram(X, Y, kind=kind, gamma=0.05),
                   ref.gram_ref(X, Y, kind=kind, gamma=0.05),
                   f"gram {kind} {M, N, d}", rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert ops.LAUNCH_COUNTS["gram"] == 4 * len(shapes)
    with pytest.raises(ValueError, match="takes"):
        gram.gram(X.double(), Y.double())


@pytest.mark.cuda
def test_lm_flash_prefill_matches_plain_and_serves(cuda):
    cfg = get_config("qwen2_5_3b").smoke().with_(dtype="bfloat16")
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 150),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    logits = {}
    for use_flash in (False, True):
        api = build(cfg.with_(use_flash=use_flash))
        caches = api.init_caches(2, 160)
        ops.reset_launch_counts()
        logits[use_flash], _ = api.prefill(params, {"tokens": tokens}, caches)
        assert ops.LAUNCH_COUNTS["flash"] == (cfg.n_layers if use_flash
                                              else 0)
    a, b = (logits[f][..., :cfg.vocab].float() for f in (True, False))
    assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n),
                    max_new_tokens=4) for i, n in enumerate((150, 20, 7))]
    ops.reset_launch_counts()
    out = LMServingEngine(cfg.with_(use_flash=True), params, batch_size=2,
                          max_len=160).run(reqs)
    assert [r.uid for r in out] == [0, 1, 2]
    assert all(len(r.output) == 4 for r in out)
    assert ops.LAUNCH_COUNTS["flash"] == 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# The node face (the asynchronous runtime's one-model calls)
# ---------------------------------------------------------------------------


def _sv_node_sub(budget=1024, d=18):
    from repro_torch.core import substrate
    return substrate.substrate_of(
        LearnerConfig(budget=budget, dim=d, kernel=KernelSpec(gamma=0.05)),
        backend="kernels")


def _sv_models(gen, n, budget, d, dev, first_id=0):
    from repro_torch.core import rkhs
    ids = torch.arange(first_id, first_id + n * budget,
                       dtype=torch.int32).view(n, budget)
    ids[:, budget - budget // 5:] = -1          # empty slots
    return rkhs.SVModel(_randn(gen, n, budget, d, dev=dev),
                        _randn(gen, n, budget, dev=dev), ids.to(dev))


@pytest.mark.cuda
def test_sv_predict_one_is_its_row_of_a_bucket_bitwise(cuda):
    """A node's ``predict_one`` (one ``sv_predict`` launch of one row)
    equals row i of a 64-row ``predict_batch`` bitwise."""
    gen = torch.Generator().manual_seed(70)
    sub, m = _sv_node_sub(), 8
    models = _sv_models(gen, m, 1024, 18, cuda)
    lids = torch.randint(0, m, (64,), generator=gen).to(cuda)
    Xb = _randn(gen, 64, 18, dev=cuda)
    ops.reset_launch_counts()
    batch = sub.predict_batch(models, lids, Xb)
    for i in range(64):
        one = type(models)(*(v[lids[i]] for v in models))
        assert torch.equal(sub.predict_one(one, Xb[i]), batch[i]), i
    assert ops.LAUNCH_COUNTS["sv_predict"] == 65


@pytest.mark.cuda
def test_dist_one_is_three_single_form_launches_bitwise(cuda):
    """The node's dynamic check: ``dist_one`` runs one ``quadform``
    launch of 3 forms (``ops.rkhs_dist_sq`` at m = 1), bitwise
    <f, f> + <g, g> - 2 <f, g> from three one-form launches."""
    from repro_torch.core import rkhs
    gen = torch.Generator().manual_seed(71)
    sub = _sv_node_sub()
    f, g = (type(m)(*(v[0] for v in m))
            for m in (_sv_models(gen, 1, 1024, 18, cuda),
                      _sv_models(gen, 1, 1024, 18, cuda, first_id=5000)))
    ops.reset_launch_counts()
    got = sub.dist_one(f, g)
    assert ops.LAUNCH_COUNTS["quadform"] == 1
    af, ag = rkhs.masked_alpha(f)[None], rkhs.masked_alpha(g)[None]
    kw = dict(kind="gaussian", gamma=0.05)
    one = [ops.quadform(X[None], Y[None], a, b, **kw)[0]
           for X, Y, a, b in ((f.sv, f.sv, af, af), (g.sv, g.sv, ag, ag),
                              (f.sv, g.sv, af, ag))]
    assert torch.equal(got, one[0] + one[1] - 2.0 * one[2])


@pytest.mark.cuda
def test_sv_aggregate_at_full_width_keeps_the_reference_model(cuda):
    """The coordinator's aggregate of 32 budget-1024 models (a mix of
    65,536 slots) under ``"kernels"``: epsilon from one ``quadform`` form
    and no Gram, so it adds at most 1 GiB to the device's peak; the
    same kept model, bitwise, and the same union as ``"reference"``
    (whose plain Gram is 17.2 GB), epsilon within the parity pair."""
    import dataclasses
    gen = torch.Generator().manual_seed(72)
    sub = _sv_node_sub()
    n = 32
    stack = _sv_models(gen, n, 1024, 18, cuda)
    models = [type(stack)(*(v[i] for v in stack)) for i in range(n)]
    ref_model = type(stack)(*(v[0] for v in _sv_models(
        gen, 1, 1024, 18, cuda, first_id=10 ** 6)))
    weights = [0.6 + 0.01 * i for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    got, eps, union = sub.aggregate(ref_model, models, weights)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert ops.LAUNCH_COUNTS == {"quadform": 1}, dict(ops.LAUNCH_COUNTS)
    assert peak <= 1 << 30, peak
    plain = dataclasses.replace(sub, backend="reference")
    want, ref_eps, ref_union = plain.aggregate(ref_model, models, weights)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert union == ref_union and len(union) == n * 820 + 820
    np.testing.assert_allclose(eps, ref_eps, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)


# ---------------------------------------------------------------------------
# engine.sweep on a stacked config axis, and the participation mask
# ---------------------------------------------------------------------------

SIM_FIELDS = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
              "sync_rounds", "divergences", "eps_history")


def _sweep_learner(family):
    """(learner, m, dynamic delta, round kernel) at an engaged size: SV
    budget 130, RFF D 256, linear m 130."""
    if family == "sv":
        return (LearnerConfig(budget=130, dim=18, kernel=KernelSpec(
            gamma=0.05)), 8, 4.0, "sv_predict")
    if family == "rff":
        return (RFFSpec(dim=18, num_features=256, gamma=0.05, seed=0), 8,
                1.5, "rff_step")
    return LearnerConfig(algo="linear_sgd", dim=18), 130, 4.0, "linear_step"


def _assert_same_sim(a, b, label):
    for field in SIM_FIELDS:
        assert np.array_equal(getattr(a, field), getattr(b, field)), \
            (label, field)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_sweep_row_is_its_solo_run_bitwise(family, cuda):
    """A grid of mixed kinds stacked on n m rows: one round launch a
    round for the group, and every row bitwise its solo ``run``."""
    learner, m, delta, step = _sweep_learner(family)
    X, Y = susy_stream(60, m, d=18, seed=5)
    grid = [ProtocolConfig(kind="dynamic", delta=delta, mini_batch=3),
            ProtocolConfig(kind="dynamic", delta=2 * delta, mini_batch=5),
            ProtocolConfig(kind="periodic", period=7),
            ProtocolConfig(kind="continuous")]
    ops.reset_launch_counts()
    sw = engine.sweep(learner, grid, X, Y, backend="kernels",
                      record_divergence=True, device=cuda)
    assert ops.LAUNCH_COUNTS[step] == 60, dict(ops.LAUNCH_COUNTS)
    for i, p in enumerate(grid):
        solo = engine.run(learner, p, X, Y, backend="kernels",
                          record_divergence=True, device=cuda)
        _assert_same_sim(sw[i], solo, f"{family}[{i}]")
    assert sw[0].num_syncs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_grouped_dist_is_each_configs_own_launch_bitwise(kind, cuda):
    """``ops.rkhs_dist_sq_groups``: g configs' 2m + 1 forms in one
    launch, each config's distances bitwise its own launch, whatever
    references sit beside it."""
    gen = torch.Generator().manual_seed(90)
    g, m, N = 6, 8, 256
    F = _randn(gen, g, m, N, 18, dev=cuda)
    G = _randn(gen, g, N, 18, dev=cuda)
    af, ag = _randn(gen, g, m, N, dev=cuda), _randn(gen, g, N, dev=cuda)
    af[:, :, N // 3:] = 0.0
    kw = dict(kind=kind, gamma=0.05)
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq_groups(F, G, af, ag, **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}
    for k in range(g):
        assert torch.equal(got[k], ops.rkhs_dist_sq(F[k], G[k], af[k], ag[k],
                                                    **kw)), k
    # the same configs beside other references
    G2 = G.flip(0)
    again = ops.rkhs_dist_sq_groups(F[:1], G[:1], af[:1], ag[:1], **kw)
    assert torch.equal(again[0], got[0])
    mixed = ops.rkhs_dist_sq_groups(torch.cat([F[:1], F[1:]]),
                                    torch.cat([G[:1], G2[1:]]),
                                    af, torch.cat([ag[:1], ag.flip(0)[1:]]),
                                    **kw)
    assert torch.equal(mixed[0], got[0])


@pytest.mark.cuda
def test_masked_sv_sync_keeps_the_reference_backends_model(cuda):
    """The cohort average of a trained SV stack under ``"kernels"``
    (epsilon from one ``quadform`` form, no Gram) keeps the model
    ``"reference"`` keeps, bitwise; epsilon within the parity pair."""
    import dataclasses
    from repro_torch.core import substrate
    gen = torch.Generator().manual_seed(91)
    m, budget = 8, 256
    sub = substrate.substrate_of(
        LearnerConfig(budget=budget, dim=18, kernel=KernelSpec(gamma=0.05)),
        backend="kernels").on(cuda)
    state = sub.init(m, cuda)
    for _ in range(300):
        x = _randn(gen, m, 18, dev=cuda)
        y = torch.where(_randn(gen, m, dev=cuda) > 0, 1.0, -1.0)
        state, _, _ = sub.round_stacked(state, (x, y))
    models = sub.models_of(state)
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.bool,
                        device=cuda)
    ops.reset_launch_counts()
    got, eps = sub.average_stacked_masked(models, mask)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}
    plain = dataclasses.replace(sub, backend="reference")
    want, ref_eps = plain.average_stacked_masked(models, mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _close(eps, ref_eps, "masked sync eps")
    every = torch.ones(m, dtype=torch.bool, device=cuda)
    for a, b in zip(sub.average_stacked_masked(models, every)[0],
                    sub.average_stacked(models)[0]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_all_true_mask_is_run_bitwise(family, cuda):
    """An all-True mask is the unmasked run, bitwise; a partial mask's
    run repeats bitwise and launches the round kernel every round."""
    learner, m, delta, step = _sweep_learner(family)
    X, Y = susy_stream(50, m, d=18, seed=6)
    p = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=3)
    kw = dict(backend="kernels", record_divergence=True, device=cuda)
    solo = engine.run(learner, p, X, Y, **kw)
    full = engine.run(learner, p, X, Y,
                      participation=np.ones((50, m), bool), **kw)
    _assert_same_sim(full, solo, family)
    mask = np.random.default_rng(6).random((50, m)) < 0.7
    ops.reset_launch_counts()
    part = engine.run(learner, p, X, Y, participation=mask, **kw)
    assert ops.LAUNCH_COUNTS[step] == 50
    _assert_same_sim(part, engine.run(learner, p, X, Y, participation=mask,
                                      **kw), f"{family} repeat")


def _mesh_learner(family):
    """``_sweep_learner`` with m divisible by 4 shards that each engage
    (linear: 128 learners a shard)."""
    learner, m, delta, step = _sweep_learner(family)
    return learner, (512 if family == "linear" else m), delta, step


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_four_shard_mesh_on_one_card_is_the_single_device_run(family, cuda):
    """``engine.run(mesh=)`` with 4 shards on ``cuda:0``: every shard
    launches its own round kernel, and the run, a masked run and a
    sweep equal the single-device ones bitwise."""
    from repro_torch.launch.mesh import make_learner_mesh
    learner, m, delta, step = _mesh_learner(family)
    T = 60
    X, Y = susy_stream(T, m, d=18, seed=7)
    mesh = make_learner_mesh(devices=["cuda:0"] * 4)
    grid = [ProtocolConfig(kind="dynamic", delta=delta, mini_batch=3),
            ProtocolConfig(kind="periodic", period=7)]
    kw = dict(backend="kernels", record_divergence=True)
    for p in grid:
        solo = engine.run(learner, p, X, Y, device=cuda, **kw)
        ops.reset_launch_counts()
        got = engine.run(learner, p, X, Y, mesh=mesh, **kw)
        assert ops.LAUNCH_COUNTS[step] == 4 * T, dict(ops.LAUNCH_COUNTS)
        _assert_same_sim(got, solo, f"{family} {p.kind}")
        assert solo.num_syncs > 0
    mask = np.random.default_rng(7).random((T, m)) < 0.7
    _assert_same_sim(
        engine.run(learner, grid[0], X, Y, participation=mask, mesh=mesh,
                   **kw),
        engine.run(learner, grid[0], X, Y, participation=mask, device=cuda,
                   **kw), f"{family} masked")
    sw = engine.sweep(learner, grid, X, Y, mesh=mesh, **kw)
    one = engine.sweep(learner, grid, X, Y, device=cuda, **kw)
    for i in range(len(grid)):
        _assert_same_sim(sw[i], one[i], f"{family} sweep[{i}]")


@pytest.mark.cuda
def test_mesh_serving_on_one_card_is_the_unmeshed_serving(cuda):
    """RFF serving on 4 shards of ``cuda:0``: ``sim`` bitwise the
    unmeshed engine's, predict chunks launched on their home shard."""
    from repro_torch.launch.mesh import make_learner_mesh
    learner, m, delta, _ = _mesh_learner("rff")
    X, Y = susy_stream(40, m, d=18, seed=8)
    p = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=3)
    kw = dict(arrivals=make_arrivals("poisson", rate=8.0, seed=0),
              backend="kernels", policy="continuous", slots=2)
    base = serve_stream(learner, p, X, Y, device=cuda, **kw)
    ops.reset_launch_counts()
    got = serve_stream(learner, p, X, Y,
                       mesh=make_learner_mesh(devices=["cuda:0"] * 4), **kw)
    assert ops.LAUNCH_COUNTS["rff"] == got.launches > 0
    _assert_same_sim(got.sim, base.sim, "mesh serving")


@pytest.mark.cuda
def test_kernels_at_a_shards_shapes_match_plain(cuda):
    """A full-width shard's shapes (32 SV learners and 1024 linear ones
    over 4 shards): ``sv_predict`` at B 8, the 17-form check,
    ``rkhs_dist_sq_each``'s 24 forms (bitwise the check on an equal
    stack), the RFF step at B 8 and the linear step at B 256."""
    gen = torch.Generator().manual_seed(91)
    kw = dict(kind="gaussian", gamma=0.05)
    m, N = 8, 1024
    X, SV = _randn(gen, m, 18, dev=cuda), _randn(gen, m, N, 18, dev=cuda)
    A = _randn(gen, m, N, dev=cuda)
    _close(fused.sv_predict(X, SV, A, **kw), ref.sv_predict_ref(X, SV, A, **kw),
           "sv_predict B=8")
    F, G = SV, _randn(gen, N, 18, dev=cuda)
    af, ag = A.clone(), _randn(gen, N, dev=cuda)
    af[:, N // 2:] = 0.0
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    each = ops.rkhs_dist_sq_each(F, G.expand(m, N, 18).contiguous(), af,
                                 ag.expand(m, N).contiguous(), **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 2}
    assert torch.equal(each, got)
    q = ref.quadform_ref(torch.cat([F, G[None], F]),
                         torch.cat([F, G[None], G.expand(m, N, 18)]),
                         torch.cat([af, ag[None], af]),
                         torch.cat([af, ag[None], ag.expand(m, N)]), **kw)
    _close(got, q[:m] + q[m:m + 1] - 2.0 * q[m + 1:], "17-form check")
    for B, D, W in ((8, 2048, True), (256, 18, False)):
        x, y = _randn(gen, B, 18, dev=cuda), torch.sign(
            _randn(gen, B, dev=cuda))
        w, b = _randn(gen, B, D, dev=cuda), _randn(gen, B, dev=cuda)
        extra = (dict(W=_randn(gen, D, 18, dev=cuda),
                      bias=_randn(gen, D, dev=cuda), scale=(2.0 / D) ** 0.5)
                 if W else {})
        outs = fused.primal_step(x, y, w, b, loss="hinge", eta=0.5, lam=0.01,
                                 **extra)
        wants = ref.primal_step_ref(x, y, w, b, loss="hinge", eta=0.5,
                                    lam=0.01, **extra)
        for o, wt in zip(outs, wants):
            _close(o, wt, f"primal_step B={B} D={D}")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_mesh_across_cards_is_the_single_device_run(family, cuda):
    """One shard a card (``make_learner_mesh()``): each shard launches on
    its own card, the syncs gather on ``cuda:0``, and the run, a masked
    run and a routed serving run equal the single-device ones bitwise.
    Needs two cards or more."""
    from repro_torch.launch.mesh import make_learner_mesh
    from repro_torch.launch.serve import make_kernel_serving_engine
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two CUDA cards or more")
    learner, m, delta, step = _mesh_learner(family)
    m = m * cards // 4 if family == "linear" else 8 * cards
    T = 40
    X, Y = susy_stream(T, m, d=18, seed=9)
    mesh = make_learner_mesh()
    assert [d.index for d in mesh.devices] == list(range(cards))
    p = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=3)
    kw = dict(backend="kernels", record_divergence=True)
    solo = engine.run(learner, p, X, Y, device=cuda, **kw)
    ops.reset_launch_counts()
    _assert_same_sim(engine.run(learner, p, X, Y, mesh=mesh, **kw), solo,
                     f"{family} across {cards} cards")
    assert ops.LAUNCH_COUNTS[step] == cards * T
    assert solo.num_syncs > 0
    mask = np.random.default_rng(9).random((T, m)) < 0.7
    _assert_same_sim(
        engine.run(learner, p, X, Y, participation=mask, mesh=mesh, **kw),
        engine.run(learner, p, X, Y, participation=mask, device=cuda, **kw),
        f"{family} masked across cards")
    eng = make_kernel_serving_engine(learner, p, m, backend="kernels")
    base = KernelServingEngine(learner, p, m, backend="kernels", device=cuda)
    reqs = {}
    for e in (eng, base):
        for t in range(T):
            for i in range(m):
                e.feedback(X[t, i], Y[t, i], learner=i, at=float(t + 1))
        rng = np.random.default_rng(0)
        reqs[id(e)] = [e.submit(X[int(rng.integers(T)), lid], learner=lid,
                                at=float(rng.uniform(0, T)))
                       for lid in rng.integers(m, size=64).tolist()]
    got, want = eng.serve(), base.serve()
    _assert_same_sim(got.sim, want.sim, f"{family} serving across cards")
    assert [r.yhat for r in reqs[id(eng)]] == [r.yhat for r in reqs[id(base)]]


# ---------------------------------------------------------------------------
# The protocol operators and the LM trainer on the card
# ---------------------------------------------------------------------------


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(dev) if torch.is_tensor(x) else x, tree)


@pytest.mark.cuda
def test_train_rounds_on_the_card_equal_the_cpu(cuda):
    from repro_torch.launch import train
    from repro_torch.optim import OptimizerConfig

    cfg = get_config("qwen2_5_3b").smoke()
    opt_cfg = OptimizerConfig(kind="sgd", lr=0.05, momentum=0.9, grad_clip=1.0)
    pcfg = ProtocolConfig(kind="dynamic", delta=0.05, per_group=True)
    step = train.make_train_step(cfg, pcfg, opt_cfg)
    cpu = train.init_train_state(0, cfg, 2, opt_cfg, device="cpu")
    card = _to(cpu, cuda)
    rng = np.random.default_rng(0)
    for t in range(4):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 17)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        cpu, lc = step(cpu, batch)
        card, lg = step(card, _to(batch, cuda))
        assert int(card.pstate.syncs) == int(cpu.pstate.syncs), t
        assert card.pstate.bytes_sent.cpu().numpy().tobytes() == \
            cpu.pstate.bytes_sent.numpy().tobytes(), t
        _close(lg, lc, f"loss {t}")
    assert 0 < int(cpu.pstate.syncs) < 4


@pytest.mark.cuda
def test_adaptive_controller_on_the_card_equals_the_cpu(cuda):
    from repro_torch.core import protocol
    from repro_torch.data import drifting_stream

    def update(model, ex):
        x, y = ex
        ell = torch.clamp(1.0 - y * (model["w"] @ x), min=0.0)
        g = torch.where(ell > 0, -y, torch.zeros_like(y))
        return {"w": model["w"] - 0.2 * g * x}, ell

    cfg = ProtocolConfig(kind="dynamic", delta=1e-3, delta_schedule="adaptive",
                         target_sync_rate=0.10, adapt_up=2.0)
    step = protocol.make_protocol_step(cfg, update)
    X, Y = drifting_stream(200, 4, d=8, seed=0, drift_every=50)
    out = []
    for dev in ("cpu", cuda):
        st = {"w": torch.zeros((4, 8), device=dev)}
        state = protocol.init_state({"w": torch.zeros(8, device=dev)}, 4)
        for t in range(200):
            st, state, _ = step(st, state, (torch.as_tensor(X[t], device=dev),
                                            torch.as_tensor(Y[t], device=dev)))
        out.append((int(state.syncs),
                    state.bytes_sent.cpu().numpy().tobytes()))
    assert out[0] == out[1] and out[0][0] > 0


@pytest.mark.cuda
def test_value_equal_engine_run_compiles_nothing(cuda):
    from repro_torch.telemetry import CompileCounter

    cfg = LearnerConfig(algo="kernel_sgd", dim=6, budget=32,
                        kernel=KernelSpec(kind="gaussian", gamma=0.2))
    pcfg = ProtocolConfig(kind="dynamic", delta=0.5)
    X, Y = susy_stream(20, 4, d=6, seed=0)
    engine.run(cfg, pcfg, X, Y, backend="kernels")
    with CompileCounter() as c:
        engine.run(cfg, ProtocolConfig(kind="dynamic", delta=0.5), X, Y,
                   backend="kernels")
    assert c.compiles == 0, c.events


@pytest.mark.cuda
def test_train_state_checkpoint_on_the_card_restores_bitwise(cuda, tmp_path):
    from repro_torch import checkpoint
    from repro_torch.launch import train
    from repro_torch.optim import OptimizerConfig
    from repro_torch.tree import leaves

    cfg = get_config("qwen2_5_3b").smoke().with_(dtype="bfloat16")
    opt_cfg = OptimizerConfig(kind="adamw", lr=1e-3)
    state = train.init_train_state(0, cfg, 2, opt_cfg, device=cuda)
    path = checkpoint.save_step(str(tmp_path), 0, state)
    got = checkpoint.restore(path, train.init_train_state(1, cfg, 2, opt_cfg,
                                                          device=cuda))
    for g, w in zip(leaves(got), leaves(state)):
        assert g.device.type == "cuda" and torch.equal(g, w)


# ---------------------------------------------------------------------------
# The Mamba-2 SSM family and the dense configs' head layouts
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_ssm_smoke_on_the_card_equals_the_cpu(cuda):
    """``mamba2_130m``'s smoke model (float32) from one set of weights:
    forward, prefill (the padding path) and 3 decode steps on the card
    against the CPU, no kernel launched, the state's dtypes kept."""
    cfg = get_config("mamba2_130m").smoke()
    api = build(cfg)
    cpu = api.init(0, device="cpu")
    card = _to(cpu, cuda)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 37)))
    ops.reset_launch_counts()
    _close(api.forward(card, {"tokens": tokens.to(cuda)})[0],
           api.forward(cpu, {"tokens": tokens})[0], "forward")
    got = api.prefill(card, {"tokens": tokens.to(cuda)},
                      api.init_caches(2, 8, device=cuda))
    want = api.prefill(cpu, {"tokens": tokens},
                       api.init_caches(2, 8, device="cpu"))
    for step in range(3):
        _close(got[0], want[0], f"logits {step}")
        nxt = torch.argmax(want[0][:, -1, :cfg.vocab], dim=-1)[:, None]
        got = api.decode(card, got[1], nxt.to(cuda), 37 + step)
        want = api.decode(cpu, want[1], nxt, 37 + step)
    assert got[1][0].h.dtype == torch.float32
    assert got[1][0].h.device.type == cuda.type
    assert not ops.LAUNCH_COUNTS


@pytest.mark.cuda
def test_ssm_train_rounds_on_the_card_equal_the_cpu(cuda):
    from repro_torch.launch import train
    from repro_torch.optim import OptimizerConfig

    cfg = get_config("mamba2_130m").smoke()
    opt_cfg = OptimizerConfig(kind="sgd", lr=0.05, grad_clip=1.0)
    step = train.make_train_step(
        cfg, ProtocolConfig(kind="periodic", period=2), opt_cfg)
    cpu = train.init_train_state(0, cfg, 2, opt_cfg, device="cpu")
    card = _to(cpu, cuda)
    rng = np.random.default_rng(0)
    for t in range(4):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 2, 33)))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        cpu, lc = step(cpu, batch)
        card, lg = step(card, _to(batch, cuda))
        assert int(card.pstate.syncs) == int(cpu.pstate.syncs) == (t + 1) // 2
        assert card.pstate.bytes_sent.cpu().numpy().tobytes() == \
            cpu.pstate.bytes_sent.numpy().tobytes(), t
        _close(lg, lc, f"loss {t}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_14b"])
def test_flash_at_the_dense_configs_head_layouts(arch, cuda):
    """The flash path at the config's own heads (32/8, 40/8 with
    ``qk_norm``; hd 128) in bf16, two layers, d cut to 1024: each layer's
    output within 2 bf16 ulps (plus 2e-5) of the plain attention on the
    same q, k, v, and the prefill within 2e-2 of the largest logit."""
    from repro_torch.models import attention

    full = get_config(arch)
    cfg = full.smoke().with_(dtype="bfloat16", d_model=1024, d_ff=2048,
                             n_heads=full.n_heads, n_kv_heads=full.n_kv_heads,
                             head_dim=full.head_dim, qk_norm=full.qk_norm)
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 200),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    seen = []
    orig = attention._flash_sdpa

    def checked(c, q, k, v, causal):
        o = orig(c, q, k, v, causal)
        S = q.shape[1]
        want = attention._sdpa(q, k, v, attention.causal_mask(S, S, 0, 0,
                                                              q.device),
                               attention._inv_sqrt(c.hd)).float()
        e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
        assert bool(((o.float() - want).abs()
                     <= 2 * torch.exp2(e - 7) + 2e-5).all())
        seen.append(q.shape)
        return o

    def caches():
        return build(cfg).init_caches(2, 208, device=cuda)

    attention._flash_sdpa = checked
    try:
        got = build(cfg.with_(use_flash=True)).prefill(
            params, {"tokens": tokens}, caches())[0]
    finally:
        attention._flash_sdpa = orig
    want = build(cfg).prefill(params, {"tokens": tokens}, caches())[0]
    assert len(seen) == cfg.n_layers and seen[0][2] == full.n_heads
    a, b = (x[..., :cfg.vocab].float() for x in (got, want))
    assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


# ---------------------------------------------------------------------------
# The RG-LRU hybrid, the sliding-window ring cache and the autotuner
# ---------------------------------------------------------------------------


def _loop64(a, b, r):
    """h_t = a_t h_{t-1} + b_t in float64 step by step, and the
    gradients of sum(h * r) with respect to a and b by its adjoint."""
    S = a.shape[1]
    a, b, r = a.double(), b.double(), r.double()
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    gh = torch.zeros_like(h)
    ga, gb = torch.zeros_like(a), torch.zeros_like(b)
    for t in reversed(range(S)):
        gh = gh + r[:, t]
        gb[:, t] = gh
        if t:
            ga[:, t] = gh * hs[t - 1]
        gh = gh * a[:, t]
    return torch.stack(hs, 1), ga, gb


@pytest.mark.cuda
def test_rglru_scan_at_full_width_matches_a_float64_loop(cuda):
    """``recurrentgemma_9b``'s width (W 4096) at the trainer's length
    (S 2,304): the scan and its gradients with respect to a and b, each
    within 1e-5 of the largest float64 value."""
    from repro_torch.models import rglru

    gen = torch.Generator(device=cuda).manual_seed(0)
    S, W = 2304, 4096
    a = 0.9 + 0.1 * torch.rand((1, S, W), generator=gen, device=cuda)
    b = torch.randn((1, S, W), generator=gen, device=cuda)
    r = torch.randn((1, S, W), generator=gen, device=cuda)
    a.requires_grad_(True)
    b.requires_grad_(True)
    h = rglru._scan(a, b)
    ga, gb = torch.autograd.grad((h * r).sum(), (a, b))
    want = _loop64(a.detach(), b.detach(), r)
    for got, w, name in zip((h.detach(), ga, gb), want, ("h", "da", "db")):
        assert bool(torch.isfinite(got).all()), name
        err = float((got.double() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


@pytest.mark.cuda
def test_ring_decode_at_full_width_matches_the_windowed_forward(cuda):
    """One layer of each kind of ``recurrentgemma_9b`` at full width
    (d 4096, 16 heads over 1 kv head of 256, window 2048, float32): a
    2,100-token prefill (the ring path) and 6 teacher-forced decode
    steps, each within 2e-2 of the largest logit of one windowed full
    forward (tests/test_decode.py:37); no kernel launched."""
    cfg = get_config("recurrentgemma_9b").with_(n_layers=3, dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    n, steps = 2100, 6
    tokens = torch.randint(0, cfg.vocab, (1, n + steps),
                           generator=torch.Generator().manual_seed(1)).to(cuda)
    ops.reset_launch_counts()
    with torch.no_grad():
        full = api.forward(params, {"tokens": tokens})[0][..., :cfg.vocab]
        caches = api.init_caches(1, n + steps + 8, device=cuda)
        assert caches[2].length == 2048
        logits, caches = api.prefill(params, {"tokens": tokens[:, :n]},
                                     caches)
        for step in range(steps + 1):
            pos = n - 1 + step
            want = full[:, pos]
            got = logits[:, -1, :cfg.vocab]
            assert float((got - want).abs().max()) <= \
                2e-2 * float(want.abs().max()), step
            if step < steps:
                logits, caches = api.decode(
                    params, caches, tokens[:, pos + 1:pos + 2], pos + 1)
    assert sorted(caches[2].slot_pos.tolist()) == list(
        range(n + steps - 2048, n + steps))
    assert not ops.LAUNCH_COUNTS


@pytest.mark.cuda
def test_every_autotune_candidate_is_bitwise_the_default(cuda):
    """Each op at a few shapes: every candidate's output bitwise the
    default geometry's; a search with ``measure`` caches its choice and
    a second resolution is a hit that compiles nothing."""
    from repro_torch.kernels import autotune
    from repro_torch.telemetry import CompileCounter

    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    autotune.clear_cache()
    try:
        for M, D in ((1, 2048), (16, 2048), (64, 2048), (100, 33), (24, 5000)):
            X, W, b = randn(M, 18), randn(D, 18), randn(D)
            default = rff.rff(X, W, b)
            for rows, cols in autotune.candidates_for("rff", (M, D)):
                got = rff.rff(X, W, b, block_m=rows, block_d=cols)
                assert torch.equal(got, default), (M, D, rows)
        for N in (1, 130, 1024, 1025):
            X, SV, A = randn(4, 18), randn(4, N, 18), randn(4, N)
            default = fused.sv_predict(X, SV, A, gamma=0.05)
            for (chunk,) in autotune.candidates_for("sv_predict", (N, 18)):
                assert torch.equal(fused.sv_predict(X, SV, A, gamma=0.05,
                                                    block_n=chunk), default)
        X, W, b = randn(64, 18), randn(2048, 18), randn(2048)

        def measure(blocks):
            return rff.rff(X, W, b, block_m=blocks[0], block_d=blocks[1])

        autotune.clear_cache()      # the calls above cached the defaults
        blocks = autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                                       measure=measure)
        choice = autotune.cache_info()[("rff", (64, 2048), "float32",
                                        "d=18")]
        assert choice.source == "search" and len(choice.times_ms) == 4
        with CompileCounter() as c:
            assert autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                                         measure=measure) == blocks
        assert c.compiles == 0
    finally:
        autotune.clear_cache()


# ---------------------------------------------------------------------------
# M-RoPE with the VLM prefix, and MLA
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mla_absorbed_decode_at_full_width_equals_naive(cuda):
    """One ``minicpm3_4b`` layer at full width (d 2560, 40 heads,
    kv_lora 256, nope 64, rope 32, v 64) in float32: a 512-token
    prefill into the latent cache, then 4 decode steps, each absorbed
    output within rtol 1e-4, atol 1e-5 of the naive one on a copy of
    the cache (tests/test_attention.py:58)."""
    from repro_torch.models import attention, transformer

    cfg = get_config("minicpm3_4b").with_(n_layers=1, dtype="float32")
    p = attention.mla_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                           torch.float32)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 516, cfg.d_model, generator=gen).to(cuda)
    cache = attention.init_mla_cache(cfg, 2, 520, torch.float32, cuda)
    ops.reset_launch_counts()
    with torch.no_grad():
        _, cache = transformer._mla_prefill(cfg, p, x[:, :512], None, cache)
        for t in range(512, 516):
            copy = attention.MLACache(*(c.clone() for c in cache))
            naive, _ = attention.mla_decode(cfg, p, x[:, t:t + 1], t, copy,
                                            absorbed=False)
            got, cache = attention.mla_decode(cfg, p, x[:, t:t + 1], t, cache)
            _close(got, naive, f"absorbed vs naive at {t}", rtol=1e-4,
                   atol=1e-5)
    assert cache.slot_pos.tolist() == list(range(516)) + [-1] * 4
    assert not ops.LAUNCH_COUNTS


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_vlm_flash_prefill_layer_at_full_width(B, cuda):
    """One ``qwen2_vl_2b`` layer at full width (d 1536, 12 heads over 2
    kv heads of 128, M-RoPE sections (16, 24, 24), bf16) over 1,024 patch
    embeddings and 300 tokens (S 1,324, distinct streams on the grid):
    the flash output within 2 bf16 ulps (plus 2e-5) of the plain
    attention on the same rotated q, k, v, one launch.  At B = 1 the
    folded heads are a strided view until copied."""
    from repro_torch.models import attention

    cfg = get_config("qwen2_vl_2b").with_(use_flash=True)
    p = attention.gqa_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                           torch.bfloat16)
    side, text = 32, 300
    h, w = torch.meshgrid(torch.arange(side), torch.arange(side),
                          indexing="ij")
    img = torch.stack([torch.zeros(side * side, dtype=torch.int64),
                       h.reshape(-1), w.reshape(-1)])
    pos = torch.cat([img, torch.arange(side, side + text).expand(3, text)],
                    dim=1)[:, None].expand(3, B, -1).to(cuda)
    x = torch.randn(B, pos.shape[2], cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    x = x.to(torch.bfloat16)
    seen = []
    orig = attention._flash_sdpa

    def checked(c, q, k, v, causal):
        o = orig(c, q, k, v, causal)
        S = q.shape[1]
        want = attention._sdpa(q, k, v, attention.causal_mask(S, S, 0, 0,
                                                              q.device),
                               attention._inv_sqrt(c.hd)).float()
        e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
        assert bool(((o.float() - want).abs()
                     <= 2 * torch.exp2(e - 7) + 2e-5).all())
        seen.append(q.shape)
        return o

    ops.reset_launch_counts()
    attention._flash_sdpa = checked
    try:
        with torch.no_grad():
            out = attention.gqa_forward(cfg, p, x, pos)
    finally:
        attention._flash_sdpa = orig
    assert seen == [(B, 1324, 12, 128)], seen
    assert dict(ops.LAUNCH_COUNTS) == {"flash": 1}
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# The MoE family and the encoder-decoder
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_moe_layer_at_full_width_grouped_equals_einsum(cuda):
    """One ``olmoe_1b_7b`` MoE layer at full width (d 2048, 64 experts,
    top 8, expert_ff 1024) in bf16 on 2 x 128 tokens, one group (G = T
    = 256): the grouped path's routing exactly the einsum oracle's
    (experts, positions, keep), its output within 3e-2 of |want| plus
    3e-2 of the largest |want| of the oracle's (bf16 combine against
    float32), the scatter form within 1e-2 of the oracle; forward and
    backward bitwise on a repeat with deterministic algorithms on.  Then
    the router's columns 32 to 63 copies of 0 to 31, so every token's
    probabilities tie in pairs: the experts and their order equal a
    stable descending sort's on the CPU (the lower index first)."""
    from repro_torch.models import moe

    cfg = get_config("olmoe_1b_7b")
    p = moe.moe_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                     torch.bfloat16)
    x = torch.randn(2, 128, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    x = x.to(torch.bfloat16)
    T, K, E = 256, cfg.top_k, cfg.n_experts
    with torch.no_grad():
        got, aux = moe.moe_forward(cfg, p, x)
        want, aux_e = moe.moe_forward_einsum(cfg, p, x)
        scat, _ = moe.moe_forward_scatter(cfg, p, x)
        _, _, _, idx, pos, keep, G, Cg = moe.route_grouped(
            cfg, p, x.reshape(T, -1), T)
        _, _, _, idx_e = moe._router(cfg, p, x.reshape(T, -1))
        pos_e = moe._positions(idx_e.reshape(T * K), E).reshape(T, K)
    assert G == T and moe._capacity(T, cfg) == Cg == 40
    assert torch.equal(idx, idx_e)
    assert torch.equal(pos.reshape(T, K), pos_e)
    assert torch.equal(keep.reshape(T, K), pos_e < Cg)
    w, g = want.float(), got.float()
    assert bool(((g - w).abs() <= 3e-2 * w.abs()
                 + 3e-2 * w.abs().max()).all())
    _close(scat.float(), w, "scatter vs einsum", rtol=1e-2, atol=1e-2)
    assert float(aux) == float(aux_e) and float(aux) > 0

    torch.use_deterministic_algorithms(True)
    try:
        grads = []
        for _ in range(2):
            q = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                     else {"w": v["w"].clone().requires_grad_(True)})
                 for k, v in p.items()}
            y, a = moe.moe_forward(cfg, q, x)
            (y.float().square().sum() + a).backward()
            grads.append([q["router"]["w"].grad] + [q[k].grad for k in (
                "wi", "wg", "wo")] + [y])
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*grads):
        assert torch.equal(a, b)

    w = p["router"]["w"].clone()
    w[:, E // 2:] = w[:, :E // 2]
    tied = dict(p, router={"w": w})
    with torch.no_grad():
        _, probs, _, idx = moe._router(cfg, tied, x.reshape(T, -1))
    pr = probs.cpu().numpy()
    order = np.argsort(-pr, axis=-1, kind="stable")[:, :K]
    top = np.sort(pr, axis=-1)[:, ::-1]
    assert np.all(top[:, 0] == top[:, 1])               # every token ties
    assert idx.cpu().numpy().tolist() == order.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_granite_moe_flash_prefill_layer_hd64(B, cuda):
    """One ``granite_moe_1b_a400m`` attention layer at full width (d 1024,
    16 heads over 8 kv heads of 64, bf16) over 1,024 tokens: the first
    hd-64 bf16 flash at a model's length, within 2 bf16 ulps (plus 2e-5)
    of the plain attention on the same rotated q, k, v, one launch."""
    from repro_torch.models import attention

    cfg = get_config("granite_moe_1b_a400m").with_(use_flash=True)
    p = attention.gqa_init(torch.Generator(device=cuda).manual_seed(0), cfg,
                           torch.bfloat16)
    x = torch.randn(B, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    x = x.to(torch.bfloat16)
    seen = []
    orig = attention._flash_sdpa

    def checked(c, q, k, v, causal):
        o = orig(c, q, k, v, causal)
        S = q.shape[1]
        want = attention._sdpa(q, k, v, attention.causal_mask(S, S, 0, 0,
                                                              q.device),
                               attention._inv_sqrt(c.hd)).float()
        e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
        assert bool(((o.float() - want).abs()
                     <= 2 * torch.exp2(e - 7) + 2e-5).all())
        seen.append(q.shape)
        return o

    ops.reset_launch_counts()
    attention._flash_sdpa = checked
    try:
        with torch.no_grad():
            out = attention.gqa_forward(cfg, p, x)
    finally:
        attention._flash_sdpa = orig
    assert seen == [(B, 1024, 16, 64)], seen
    assert dict(ops.LAUNCH_COUNTS) == {"flash": 1}
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_whisper_encoder_layer_at_full_width_equals_the_cpu(cuda):
    """One ``whisper_large_v3`` encoder layer at full width (d 1280, 20
    heads of 64, LayerNorm, GELU) in float32 over 1,500 frames, with the
    sinusoidal positions and the final norm (``encode``): the card
    against the CPU within the parity pair, no kernel launched (the
    non-causal 1,500-frame attention is the plain one, as the config's
    ``use_flash=False``)."""
    from repro_torch.models import encdec

    cfg = get_config("whisper_large_v3").with_(encoder_layers=1, n_layers=1,
                                               dtype="float32")
    params = encdec.init_encdec(torch.Generator().manual_seed(0), cfg)
    frames = torch.randn(1, 1500, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = encdec.encode(_to(params, cuda), cfg, frames.to(cuda))
        want = encdec.encode(params, cfg, frames)
    assert not ops.LAUNCH_COUNTS
    _close(got, want, "encoder layer, card vs CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["prefill_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "mamba2_130m",
                                  "olmoe_1b_7b"])
def test_dry_run_counts_equal_a_step_on_the_card(arch, shape, cuda,
                                                 monkeypatch):
    """The dry run's record (on ``meta``, smoke size, a (2, 2) mesh) and
    the same step on the card: FlopCounterMode's count equal, the
    inputs' bytes equal, no kernel of the port launched."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import NamedMesh
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.tree import leaves

    monkeypatch.setattr(dryrun, "get", lambda a: get_config(a).smoke().with_(
        long_context_window=16))
    monkeypatch.setitem(specs.SHAPES, "prefill_32k",
                        dict(kind="prefill", seq=16, batch=2))
    monkeypatch.setitem(specs.SHAPES, "long_500k",
                        dict(kind="decode", seq=40, batch=1))
    monkeypatch.delenv("REPRO_BASELINE", raising=False)
    rec = dryrun.count_combo(dryrun.build_combo(
        arch, shape, NamedMesh(("data", "model"), (2, 2))),
        NamedMesh(("data", "model"), (2, 2)))
    cfg = specs.variant_for(dryrun.get(arch), shape)
    sh = specs.SHAPES[shape]
    B, S = sh["batch"], sh["seq"]
    api = build(cfg)
    params = api.init(0, device=cuda)
    ops.reset_launch_counts()
    if sh["kind"] == "prefill":
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                         dtype=torch.int32, device=cuda)}
        step = make_prefill_step(cfg)
        call = args = (params, batch, api.init_caches(B, S, device=cuda))
    else:
        step = make_decode_step(cfg)
        caches = api.init_caches(B, S + specs.CACHE_MARGIN, device=cuda)
        token = torch.zeros((B, 1), dtype=torch.int32, device=cuda)
        call = (params, caches, token, S)
        args = (params, caches, token, torch.tensor(S, dtype=torch.int32,
                                                    device=cuda))
    with FlopCounterMode(display=False) as fc:
        step(*call)
    torch.cuda.synchronize()
    assert fc.get_total_flops() == rec["flops_global"]
    assert sum(x.numel() * x.element_size() for x in leaves(args)) == \
        rec["argument_size_global"]
    assert not ops.LAUNCH_COUNTS
