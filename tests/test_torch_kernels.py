"""The port's kernels: plain versions against the JAX ops, on the CPU.

Every plain PyTorch version in ``repro_torch/kernels/ref.py`` (what the
CUDA kernels must compute) is held against the JAX op run with
``force_pallas=True`` -- the Pallas kernel in interpret mode on the
CPU, exactly as tests/test_kernels_fused.py runs it -- at the edge
shapes 1, 127, 128, 129, 130 and with all-padded coefficients, under
the suite's one parity tolerance.  The wrappers are driven on CPU
tensors too: they must take the plain version and count no launch.

The CUDA kernels themselves run only on the card: see
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import fused, ops, quadform as tquad, ref

KINDS = ["gaussian", "linear", "poly"]
EDGES = [1, 127, 128, 129, 130]


def _sv_args(seed, B, N, d, padded=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, d)).astype(np.float32)
    SV = rng.normal(size=(B, N, d)).astype(np.float32)
    A = (rng.normal(size=(B, N)) * (rng.random((B, N)) < 0.8)).astype(np.float32)
    if padded:
        A = np.zeros_like(A)
    return X, SV, A


def _qf_args(seed, M, N, d, padded=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(M, d)).astype(np.float32)
    Y = rng.normal(size=(N, d)).astype(np.float32)
    a = rng.normal(size=(M,)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    if padded:
        a = np.zeros_like(a)
    return X, Y, a, b


def _step_args(seed, B, d, D=None):
    rng = np.random.default_rng(seed)
    args = (rng.normal(size=(B, d)).astype(np.float32),
            rng.choice([-1.0, 1.0], size=(B,)).astype(np.float32),
            (0.3 * rng.normal(size=(B, D or d))).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32))
    kw = {}
    if D is not None:
        kw = dict(W=rng.normal(size=(D, d)).astype(np.float32),
                  bias=rng.uniform(0, 2 * np.pi, size=(D,)).astype(np.float32),
                  scale=float(np.sqrt(2.0 / D)))
    return args, kw


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def no_launches():
    """The CPU path must never count a kernel launch."""
    ops.reset_launch_counts()
    yield
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, dict(ops.LAUNCH_COUNTS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("N", EDGES)
def test_sv_predict_plain_matches_pallas(kind, N, backend_parity, no_launches):
    X, SV, A = _sv_args(N, 3, N, 6)
    kw = dict(kind=kind, gamma=0.4)
    want = jops.sv_predict(jnp.asarray(X), jnp.asarray(SV), jnp.asarray(A),
                           force_pallas=True, **kw)
    for got in (ref.sv_predict_ref(*_t(X, SV, A), **kw),
                fused.sv_predict(*_t(X, SV, A), **kw),
                ops.sv_predict(*_t(X, SV, A), force_kernel=True, **kw)):
        assert got.shape == (3,) and got.dtype == torch.float32
        backend_parity(got.numpy(), want, f"sv_predict {kind} N={N}")


@pytest.mark.parametrize("kind", KINDS)
def test_sv_predict_all_padded_is_zero(kind, no_launches):
    X, SV, A = _sv_args(0, 2, 130, 6, padded=True)
    got = fused.sv_predict(*_t(X, SV, A), kind=kind, gamma=0.4)
    want = jops.sv_predict(jnp.asarray(X), jnp.asarray(SV), jnp.asarray(A),
                           kind=kind, gamma=0.4, force_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.zeros(2, np.float32))
    np.testing.assert_array_equal(np.asarray(want), np.zeros(2, np.float32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N", [(1, 1), (127, 129), (128, 128), (130, 1),
                                 (129, 130)])
@pytest.mark.parametrize("padded", [False, True])
def test_quadform_plain_matches_pallas(kind, M, N, padded, backend_parity,
                                       no_launches):
    X, Y, a, b = _qf_args(M + N, M, N, 5, padded)
    kw = dict(kind=kind, gamma=0.3)
    want = jops.quadform(*map(jnp.asarray, (X, Y, a, b)), force_pallas=True,
                         **kw)
    batched = [v[None] for v in _t(X, Y, a, b)]      # P = 1 form
    for got in (ref.quadform_ref(*batched, **kw),
                tquad.quadform(*batched, **kw),
                ops.quadform(*batched, force_kernel=True, **kw)):
        assert got.shape == (1,)
        backend_parity(got.numpy()[0], want, f"quadform {kind} M={M} N={N}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N", [(129, 129), (129, 5)])
def test_rkhs_dist_sq_matches_pallas(kind, M, N, backend_parity, no_launches):
    """ops.rkhs_dist_sq over m learners = the reference's vmapped three
    quadforms per learner (one batched launch when M == N on the card)."""
    m = 2
    rng = np.random.default_rng(M * N)
    F = rng.normal(size=(m, M, 4)).astype(np.float32)
    af = rng.normal(size=(m, M)).astype(np.float32)
    G = rng.normal(size=(N, 4)).astype(np.float32)
    ag = rng.normal(size=(N,)).astype(np.float32)
    kw = dict(kind=kind, gamma=0.3)
    want = [jops.rkhs_dist_sq(jnp.asarray(F[i]), jnp.asarray(G),
                              jnp.asarray(af[i]), jnp.asarray(ag), **kw)
            for i in range(m)]
    got = ops.rkhs_dist_sq(*_t(F, G, af, ag), **kw)
    backend_parity(got.numpy(), np.asarray(want), f"rkhs_dist_sq {kind}")


def _dist_args(seed, m, M, N, d=4):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(m, M, d)).astype(np.float32)
    af = rng.normal(size=(m, M)).astype(np.float32)
    af[:, M // 2:] = 0.0                 # padded slots
    G = rng.normal(size=(N, d)).astype(np.float32)
    ag = rng.normal(size=(N,)).astype(np.float32)
    return F, G, af, ag


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N", [(129, 129), (129, 5)])
@pytest.mark.parametrize("m", [1, 2, 32])
def test_rkhs_dist_sq_matches_the_vmapped_reference(m, M, N, kind,
                                                    backend_parity,
                                                    no_launches):
    """ops.rkhs_dist_sq over m learners = the reference's dynamic check
    as src/repro/core/substrate.py:492 computes it: ``ops.rkhs_dist_sq``
    vmapped over the learners with the reference model unbatched (its
    <g, g> quadform computed once), Pallas in interpret mode; M == N
    engaged (one launch on the card) and M != N."""
    F, G, af, ag = _dist_args(m * 1000 + M + N, m, M, N)
    kw = dict(kind=kind, gamma=0.3)
    want = jax.vmap(lambda f, a: jops.rkhs_dist_sq(
        f, jnp.asarray(G), a, jnp.asarray(ag), **kw))(jnp.asarray(F),
                                                      jnp.asarray(af))
    got = ops.rkhs_dist_sq(*_t(F, G, af, ag), **kw)
    assert got.shape == (m,)
    backend_parity(got.numpy(), np.asarray(want),
                   f"rkhs_dist_sq {kind} m={m} M={M} N={N}")


@pytest.mark.parametrize("M,N,groups", [(129, 129, "one"), (129, 5, "each"),
                                        (5, 5, "each")])
@pytest.mark.parametrize("m", [1, 2, 32])
def test_rkhs_dist_sq_computes_gg_once(m, M, N, groups, monkeypatch):
    """The forms handed to ``quadform``: engaged with one shape, one call
    of P = 2m + 1 (<f_i, f_i>, <g, g> once, <f_i, g>); otherwise one call
    per group, <g, g>'s of one form.  Either way the distances equal the
    3m-form arrangement (<g, g> m times) bitwise, on the CPU path too."""
    calls = []
    real = tquad.quadform
    monkeypatch.setattr(tquad, "quadform", lambda X, Y, a, b, **kw: (
        calls.append((X.shape[0], tuple(X.shape[1:]), tuple(Y.shape[1:])))
        or real(X, Y, a, b, **kw)))
    F, G, af, ag = (torch.from_numpy(a) for a in _dist_args(7, m, M, N))
    kw = dict(kind="gaussian", gamma=0.3)
    got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    engaged = ops.engages(M, N)
    if groups == "one":
        assert calls == [(2 * m + 1, (M, 4), (N, 4))]
    else:
        # the reference's per-form threshold: a group below 128 takes
        # the plain expression and never reaches the wrapper
        want = [(m, (M, 4), (M, 4)), (1, (N, 4), (N, 4)),
                (m, (M, 4), (N, 4))]
        assert calls == [c for c in want if ops.engages(c[1][0], c[2][0])]
        assert engaged == bool(calls)
    Gm, agm = G.expand(m, N, 4), ag.expand(m, N)
    three = [ops.quadform(*g, **kw) for g in ((F, F, af, af),
                                             (Gm, Gm, agm, agm),
                                             (F, Gm, af, agm))]
    assert torch.equal(got, three[0] + three[1] - 2.0 * three[2])


@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("B,D", [(1, 1), (127, 129), (128, 8), (129, 130),
                                 (130, 127)])
def test_rff_step_plain_matches_pallas(loss, B, D, backend_parity,
                                       no_launches):
    args, kw = _step_args(B + D, B, 6, D)
    hyper = dict(loss=loss, eta=0.3, lam=0.01)
    want = jops.fused_primal_step(
        *map(jnp.asarray, args), W=jnp.asarray(kw["W"]),
        bias=jnp.asarray(kw["bias"]), scale=kw["scale"], force_pallas=True,
        **hyper)
    tkw = dict(W=torch.from_numpy(kw["W"]), bias=torch.from_numpy(kw["bias"]),
               scale=kw["scale"])
    for got in (ref.primal_step_ref(*_t(*args), **tkw, **hyper),
                fused.primal_step(*_t(*args), **tkw, **hyper),
                ops.fused_primal_step(*_t(*args), force_kernel=True, **tkw,
                                      **hyper)):
        for g, w, name in zip(got, want, ["w", "b", "ell", "yhat"]):
            backend_parity(g.numpy(), w, f"rff_step/{name} {loss} B={B} D={D}")


@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("B", EDGES)
def test_linear_step_plain_matches_pallas(loss, B, backend_parity,
                                          no_launches):
    args, _ = _step_args(B, B, 7)
    hyper = dict(loss=loss, eta=0.3, lam=0.01)
    want = jops.fused_primal_step(*map(jnp.asarray, args), force_pallas=True,
                                  **hyper)
    for got in (ref.primal_step_ref(*_t(*args), **hyper),
                fused.primal_step(*_t(*args), **hyper),
                ops.fused_primal_step(*_t(*args), force_kernel=True, **hyper)):
        for g, w, name in zip(got, want, ["w", "b", "ell", "yhat"]):
            backend_parity(g.numpy(), w, f"linear_step/{name} {loss} B={B}")


def test_engages_threshold_matches_reference():
    for dims in [(1,), (127,), (128,), (2, 128), (127, 100), (130, 1)]:
        assert ops.engages(*dims) == jops.engages(*dims), dims


def test_wrappers_refuse_bad_operands():
    X, SV, A = _t(*_sv_args(0, 2, 5, 3))
    with pytest.raises(ValueError):
        fused.sv_predict(X[:1], SV, A)
    with pytest.raises(ValueError):
        fused.sv_predict(X, SV, A, kind="laplace")
    args, _ = _step_args(0, 4, 3)
    with pytest.raises(ValueError):
        fused.primal_step(*_t(*args), loss="logistic")
    with pytest.raises(ValueError):            # a linear step needs D == d
        fused.primal_step(*_t(args[0], args[1], np.zeros((4, 5), np.float32),
                              args[3]))
