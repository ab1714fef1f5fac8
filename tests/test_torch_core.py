"""The PyTorch port's core modules against the JAX reference, on the CPU.

Inputs are made from a numpy seed and handed to both packages.  Floats
are held to the suite's one parity tolerance (``backend_parity``,
tests/conftest.py); integers (ids, counters, byte counts, kept slots)
must be equal.

- streams: byte-identical arrays;
- rkhs: Gram, prediction, quadratic forms, the sorted-id set algebra
  and slot insertion (first-minimum ties);
- learners: the stacked kernel / linear rounds, id minting;
- compression: truncate / project, including the tie case an average
  after an adopt produces and the tau boundary;
- accounting: the device ledger against the reference's and the host
  oracle over random sync sequences, and the int32 guards.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as jacc
from repro.core import compression as jcomp
from repro.core import engine as jeng
from repro.core import learners as jlearn
from repro.core import rkhs as jrkhs
from repro.core import substrate as jsub
from repro.data import streams as jstreams

from repro_torch import convert
from repro_torch.core import accounting as tacc
from repro_torch.core import compression as tcomp
from repro_torch.core import engine as teng
from repro_torch.core import learners as tlearn
from repro_torch.core import rkhs as trkhs
from repro_torch.core import substrate as tsub
from repro_torch.data import streams as tstreams

KINDS = ["gaussian", "linear", "poly"]


def _spec_pair(kind, gamma=0.3, degree=3, coef0=1.0):
    return (jrkhs.KernelSpec(kind=kind, gamma=gamma, degree=degree, coef0=coef0),
            trkhs.KernelSpec(kind=kind, gamma=gamma, degree=degree, coef0=coef0))


def _stacked(seed, m, budget, d, active_frac=0.8, scale=1.0):
    """numpy (sv, alpha, sv_id) of m budgeted models; inactive slots
    carry zeros and id -1."""
    rng = np.random.default_rng(seed)
    active = rng.random((m, budget)) < active_frac
    sv = np.where(active[..., None],
                  rng.normal(size=(m, budget, d)) * scale, 0.0).astype(np.float32)
    alpha = np.where(active, rng.normal(size=(m, budget)), 0.0).astype(np.float32)
    ids = np.arange(m * budget, dtype=np.int32).reshape(m, budget)
    return sv, alpha, np.where(active, ids, -1).astype(np.int32)


def _jmodel(sv, alpha, ids):
    return jrkhs.SVModel(sv=jnp.asarray(sv), alpha=jnp.asarray(alpha),
                         sv_id=jnp.asarray(ids))


def _tmodel(sv, alpha, ids):
    return convert.sv_model(jrkhs.SVModel(sv=sv, alpha=alpha, sv_id=ids),
                            device="cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("susy_stream", dict(d=18)),
    ("susy_stream", dict(d=6, noise=0.2)),
    ("separable_stream", dict(d=5)),
    ("drifting_stream", dict(d=4, drift_every=7)),
    ("stock_stream", dict(d=10)),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_streams_byte_identical(name, kw, seed):
    Xj, Yj = getattr(jstreams, name)(23, 3, seed=seed, **kw)
    Xt, Yt = getattr(tstreams, name)(23, 3, seed=seed, **kw)
    for a, b in ((Xj, Xt), (Yj, Yt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# rkhs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_gram_predict_quadform_match(kind, backend_parity):
    js, ts = _spec_pair(kind)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(37, 5)).astype(np.float32)
    Y = rng.normal(size=(29, 5)).astype(np.float32)
    a = rng.normal(size=(37,)).astype(np.float32)
    b = rng.normal(size=(29,)).astype(np.float32)
    Kj = jrkhs.gram(js, jnp.asarray(X), jnp.asarray(Y))
    Kt = trkhs.gram(ts, torch.from_numpy(X), torch.from_numpy(Y))
    backend_parity(_np(Kt), Kj, f"gram {kind}")
    backend_parity(_np(trkhs.quadform(Kt, torch.from_numpy(a),
                                      torch.from_numpy(b))),
                   jrkhs.quadform(Kj, jnp.asarray(a), jnp.asarray(b)),
                   f"quadform {kind}")

    sv, alpha, ids = _stacked(2, 3, 11, 5)
    xq = rng.normal(size=(3, 4, 5)).astype(np.float32)
    want = jax.vmap(lambda f, x: jrkhs.predict(js, f, x))(
        _jmodel(sv, alpha, ids), jnp.asarray(xq))
    got = trkhs.predict(ts, _tmodel(sv, alpha, ids), torch.from_numpy(xq))
    backend_parity(_np(got), want, f"predict {kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_dist_and_divergence_match(kind, backend_parity):
    js, ts = _spec_pair(kind, gamma=0.2)
    sv, alpha, ids = _stacked(3, 3, 9, 4)
    rsv, ralpha, rids = _stacked(4, 1, 12, 4)
    jm, tm = _jmodel(sv, alpha, ids), _tmodel(sv, alpha, ids)
    jr = _jmodel(rsv[0], ralpha[0], rids[0])
    tr = _tmodel(rsv[0], ralpha[0], rids[0])
    backend_parity(_np(trkhs.stacked_dist_to(ts, tm, tr)),
                   jrkhs.stacked_dist_to(js, jm, jr), "stacked_dist_to")
    backend_parity(_np(trkhs.divergence_stacked(ts, tm)),
                   jrkhs.divergence_stacked(js, jm), "divergence")
    one = jax.tree.map(lambda v: v[1], jm)
    backend_parity(
        _np(trkhs.dist_sq(ts, trkhs.SVModel(*(v[1] for v in tm)), tr)),
        jrkhs.dist_sq(js, one, jr), "dist_sq")
    # Prop. 2's average is a reshape and a division: bitwise
    ja, ta = jrkhs.average_stacked(jm), trkhs.average_stacked(tm)
    for f in ("sv", "alpha", "sv_id"):
        np.testing.assert_array_equal(_np(getattr(ta, f)), getattr(ja, f))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 5, 7])
def test_int_pow_is_repeated_multiplication(degree):
    x = np.random.default_rng(5).normal(size=(64,)).astype(np.float32) * 3
    want = np.asarray(jnp.asarray(x) ** degree)
    got = _np(trkhs.int_pow(torch.from_numpy(x), degree))
    np.testing.assert_array_equal(got, want)


def _random_ids(rng, shape, hi=40):
    ids = rng.integers(0, hi, size=shape).astype(np.int32)
    ids[rng.random(shape) < 0.3] = -1
    return ids


@pytest.mark.parametrize("seed", range(4))
def test_sorted_id_set_algebra_is_integer_equal(seed):
    rng = np.random.default_rng(seed)
    ids = _random_ids(rng, (4, 9))
    for row in ids:
        ju, jn = jrkhs.sorted_unique(jnp.asarray(row))
        tu, tn = trkhs.sorted_unique(torch.from_numpy(row))
        np.testing.assert_array_equal(_np(tu), ju)
        assert int(tn) == int(jn)
    ju, jn = jax.vmap(jrkhs.sorted_unique)(jnp.asarray(ids))
    tu, tn = trkhs.sorted_unique_rows(torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(tu), ju)
    np.testing.assert_array_equal(_np(tn), jn)
    known, _ = jrkhs.sorted_unique(jnp.asarray(_random_ids(rng, (36,))))
    jc = jax.vmap(lambda q: jrkhs.count_members(q, known))(ju)
    tc = trkhs.count_members(tu, torch.from_numpy(np.array(known)))
    np.testing.assert_array_equal(_np(tc), jc)
    assert int(trkhs.union_unique_count(torch.from_numpy(ids))) == int(
        jrkhs.union_unique_count(jnp.asarray(ids)))


@pytest.mark.parametrize("evict", ["smallest", "oldest"])
@pytest.mark.parametrize("free", [True, False])
def test_insert_sv_first_minimum(evict, free):
    """Ties (equal |alpha|, several free slots) resolve to the first
    slot, as jnp.argmin does."""
    tau, d = 6, 3
    alpha = np.array([[0.5, -0.25, 0.25, 0.7, -0.25, 0.9],
                      [0.1, 0.1, 0.1, 0.1, 0.1, 0.1]], np.float32)
    ids = np.array([[7, 3, 5, 9, 1, 2], [4, 5, 6, 7, 8, 9]], np.int32)
    if free:
        ids[:, 2] = -1
        ids[:, 4] = -1
    sv = np.random.default_rng(6).normal(size=(2, tau, d)).astype(np.float32)
    x = np.ones((2, d), np.float32)
    a_new = np.array([2.0, -3.0], np.float32)
    nid = np.array([100, 101], np.int32)
    want = jax.vmap(lambda f, xi, a, i: jrkhs.insert_sv(f, xi, a, i, evict))(
        _jmodel(sv, alpha, ids), jnp.asarray(x), jnp.asarray(a_new),
        jnp.asarray(nid))
    got = trkhs.insert_sv(_tmodel(sv, alpha, ids), torch.from_numpy(x),
                          torch.from_numpy(a_new), torch.from_numpy(nid), evict)
    for f in ("sv", "alpha", "sv_id"):
        np.testing.assert_array_equal(_np(getattr(got, f)), getattr(want, f))


def test_pad_to_budget_matches():
    sv, alpha, ids = _stacked(7, 1, 5, 3)
    one = _jmodel(sv[0], alpha[0], ids[0])
    tone = _tmodel(sv[0], alpha[0], ids[0])
    for tau in (3, 5, 8):
        want, got = jrkhs.pad_to_budget(one, tau), trkhs.pad_to_budget(tone, tau)
        for f in ("sv", "alpha", "sv_id"):
            np.testing.assert_array_equal(_np(getattr(got, f)),
                                          getattr(want, f))


# ---------------------------------------------------------------------------
# learners
# ---------------------------------------------------------------------------


def _jcfg_tcfg(**kw):
    kind = kw.pop("kind", "gaussian")
    js, ts = _spec_pair(kind, gamma=0.4)
    return (jlearn.LearnerConfig(kernel=js, **kw),
            tlearn.LearnerConfig(kernel=ts, **kw))


@pytest.mark.parametrize("algo", ["kernel_sgd", "kernel_pa"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_rounds_match(algo, loss, kind, backend_parity):
    """Twelve stacked rounds, enough to fill the budget and evict:
    ids and counters equal, floats within tolerance."""
    m, tau, d = 3, 5, 6
    jc, tc = _jcfg_tcfg(algo=algo, loss=loss, kind=kind, budget=tau, dim=d)
    X, Y = jstreams.susy_stream(12, m, d=d, seed=1)
    if loss == "squared":
        Y = Y * 0.7
    jst = jax.tree.map(lambda *v: jnp.stack(v),
                       *[jlearn.init_kernel_state(jc, i) for i in range(m)])
    tst = tlearn.init_kernel_state(tc, torch.arange(m, dtype=torch.int32))
    for got, want in zip(jax.tree.leaves(convert.to_numpy(tst)),
                         jax.tree.leaves(jst)):
        np.testing.assert_array_equal(got, want)
    step = jax.vmap(lambda s, x, y: jlearn.kernel_update(jc, s, (x, y)))
    for t in range(len(X)):
        # carry the reference's state across each round so every round
        # is compared from the same start
        tst = convert.kernel_learner_state(jst, device="cpu")
        jst, jl = step(jst, jnp.asarray(X[t]), jnp.asarray(Y[t]))
        tst, tl = tlearn.kernel_update(
            tc, tst, (torch.from_numpy(X[t]), torch.from_numpy(Y[t])))
        backend_parity(_np(tl), jl, f"loss t={t}")
        np.testing.assert_array_equal(_np(tst.model.sv_id), jst.model.sv_id)
        np.testing.assert_array_equal(_np(tst.counter), jst.counter)
        backend_parity(_np(tst.model.alpha), jst.model.alpha, f"alpha t={t}")
        backend_parity(_np(tst.model.sv), jst.model.sv, f"sv t={t}")


def test_id_minting_and_capacity_guard():
    assert tlearn.MAX_LEARNERS == jlearn.MAX_LEARNERS
    assert tlearn.MAX_INSERTIONS_PER_LEARNER == jlearn.MAX_INSERTIONS_PER_LEARNER
    cap = jlearn.MAX_INSERTIONS_PER_LEARNER
    tlearn.check_id_capacity(cap)
    jlearn.check_id_capacity(cap)
    for fn in (jlearn.check_id_capacity, tlearn.check_id_capacity):
        with pytest.raises(ValueError):
            fn(cap + 1)
    # the largest id a run can mint stays a non-negative int32
    assert (cap - 1) * tlearn.MAX_LEARNERS + tlearn.MAX_LEARNERS - 1 < 2**31


@pytest.mark.parametrize("algo", ["linear_sgd", "linear_pa"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_linear_rounds_match(algo, loss, backend_parity):
    m, d = 4, 6
    jc, tc = _jcfg_tcfg(algo=algo, loss=loss, dim=d)
    X, Y = jstreams.susy_stream(6, m, d=d, seed=2)
    jst = jax.tree.map(lambda *v: jnp.stack(v),
                       *[jlearn.init_linear_state(jc) for _ in range(m)])
    step = jax.vmap(lambda s, x, y: jlearn.linear_update(jc, s, (x, y)))
    for t in range(len(X)):
        tst = convert.linear_state(jst, device="cpu")
        jst, jl = step(jst, jnp.asarray(X[t]), jnp.asarray(Y[t]))
        tst, tl = tlearn.linear_update(
            tc, tst, (torch.from_numpy(X[t]), torch.from_numpy(Y[t])))
        backend_parity(_np(tl), jl, f"loss t={t}")
        backend_parity(_np(tst.w), jst.w, f"w t={t}")
        backend_parity(_np(tst.b), jst.b, f"b t={t}")


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def _adopted_average(seed, m, tau, d, fresh):
    """The average a sync sees after an adopt: every learner holds the
    same model (equal |alpha| duplicated m times), then ``fresh`` of
    them insert one new support vector each, some with |alpha| equal to
    an adopted one."""
    rng = np.random.default_rng(seed)
    base_a = rng.choice([-0.5, 0.5, 0.25], size=(tau,)).astype(np.float32)
    base_a[-2:] = 0.0
    base_ids = np.arange(tau, dtype=np.int32)
    base_ids[-2:] = -1
    base_sv = np.where((base_ids >= 0)[:, None],
                       rng.normal(size=(tau, d)), 0.0).astype(np.float32)
    sv = np.repeat(base_sv[None], m, 0)
    alpha = np.repeat(base_a[None], m, 0)
    ids = np.repeat(base_ids[None], m, 0)
    for i in range(fresh):
        sv[i, tau - 1] = rng.normal(size=(d,))
        alpha[i, tau - 1] = 0.5 if i % 2 == 0 else -0.75
        ids[i, tau - 1] = 1000 + i
    return sv, alpha, ids


@pytest.mark.parametrize("method", ["truncate", "project"])
@pytest.mark.parametrize("fresh", [0, 2])
def test_compression_ties_after_adopt(method, fresh, backend_parity):
    m, tau, d = 3, 8, 4
    js, ts = _spec_pair("gaussian", gamma=0.5)
    sv, alpha, ids = _adopted_average(8, m, tau, d, fresh)
    jbar = jrkhs.average_stacked(_jmodel(sv, alpha, ids))
    tbar = trkhs.average_stacked(_tmodel(sv, alpha, ids))
    jf, jeps = jcomp.compress(js, jbar, tau, method)
    tf, teps = tcomp.compress(ts, tbar, tau, method)
    # which slots survive decides the next sync's bytes: integer-equal
    np.testing.assert_array_equal(_np(tf.sv_id), jf.sv_id)
    backend_parity(_np(tf.alpha), jf.alpha, "alpha")
    backend_parity(_np(tf.sv), jf.sv, "sv")
    backend_parity(_np(teps), jeps, "eps")


@pytest.mark.parametrize("method", ["truncate", "project"])
@pytest.mark.parametrize("n_active", [5, 6, 7, 12])
def test_compression_tau_boundary(method, n_active, backend_parity):
    tau, budget, d = 6, 12, 3
    js, ts = _spec_pair("gaussian", gamma=0.5)
    rng = np.random.default_rng(9)
    ids = np.full((budget,), -1, np.int32)
    slots = rng.permutation(budget)[:n_active]
    ids[slots] = rng.permutation(50)[:n_active]
    alpha = np.where(ids >= 0, rng.normal(size=(budget,)), 0.0).astype(np.float32)
    sv = np.where((ids >= 0)[:, None],
                  rng.normal(size=(budget, d)), 0.0).astype(np.float32)
    jf, jeps = jcomp.compress(js, _jmodel(sv, alpha, ids), tau, method)
    tf, teps = tcomp.compress(ts, _tmodel(sv, alpha, ids), tau, method)
    assert tf.sv_id.shape == tuple(jf.sv_id.shape) == (tau,)
    np.testing.assert_array_equal(_np(tf.sv_id), jf.sv_id)
    backend_parity(_np(tf.alpha), jf.alpha, "alpha")
    backend_parity(_np(teps), jeps, "eps")
    if n_active <= tau:
        assert float(teps) == 0.0 and float(jeps) == 0.0


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_device_ledger_matches_reference_and_host(seed):
    """Random sync sequences: ids persist, churn, and are shared after
    adopts; the port's bytes equal the reference device ledger's and
    the host oracle's at every sync."""
    rng = np.random.default_rng(seed)
    m, tau, d = 4, 7, 5
    bm_j, bm_t = jacc.ByteModel(dim=d), tacc.ByteModel(dim=d)
    led_j = jacc.device_ledger_init(m * tau)
    led_t = tacc.device_ledger_init(m * tau, device="cpu")
    host = tacc.CommunicationLedger(bm_t)
    ids = np.full((m, tau), -1, np.int32)
    next_id = 0
    for t in range(8):
        for i in range(m):
            for s in range(tau):
                r = rng.random()
                if r < 0.25:
                    ids[i, s] = next_id
                    next_id += 1
                elif r < 0.35:
                    ids[i, s] = -1
        if t % 3 == 2:      # an adopt: everyone holds learner 0's slots
            ids[:] = ids[0]
        bj, led_j = jacc.device_sync_bytes_kernel(bm_j, jnp.asarray(ids), led_j)
        bt, led_t = tacc.device_sync_bytes_kernel(bm_t, torch.from_numpy(ids),
                                                  led_t)
        bh = host.record_kernel_sync(list(ids), t)
        assert int(bt) == int(bj) == bh, t
        assert bt.dtype == torch.int64
        np.testing.assert_array_equal(_np(led_t.known), led_j.known)


def test_byte_formulas_match():
    for m in (1, 2, 5):
        for p in (9, 257):
            assert tacc.sync_bytes_linear(p, m) == jacc.sync_bytes_linear(p, m)
            assert tacc.allreduce_bytes(p, m) == jacc.allreduce_bytes(p, m)
            assert tacc.allgather_bytes(p, m) == jacc.allgather_bytes(p, m)
    bm_j, bm_t = jacc.ByteModel(dim=18), tacc.ByteModel(dim=18)
    assert (bm_t.B_x, bm_t.B_alpha) == (bm_j.B_x, bm_j.B_alpha)


def test_ledger_int32_guard_refuses_the_same_shapes():
    """accounting.py:215: at m = 32, d = 18 the largest accepted budget
    is 24209; both packages accept it and refuse 24210."""
    m, d = 32, 18
    for tau, refused in ((24209, False), (24210, True)):
        ids = np.full((m, tau), -1, np.int32)
        outcomes = []
        for acc, arr, led in (
                (jacc, jnp.asarray(ids), jacc.device_ledger_init(m * tau)),
                (tacc, torch.from_numpy(ids),
                 tacc.device_ledger_init(m * tau, device="cpu"))):
            try:
                acc.device_sync_bytes_kernel(acc.ByteModel(dim=d), arr, led)
                outcomes.append(False)
            except ValueError:
                outcomes.append(True)
        assert outcomes == [refused, refused], tau


@pytest.mark.parametrize("kind", ["linear", "sv"])
def test_allreduce_int32_guard_refuses_the_same_shapes(kind):
    """engine.py:149-157: the per-sync ring bytes guard."""
    if kind == "linear":
        jl = jlearn.LearnerConfig(algo="linear_sgd", dim=18)
        tl = tlearn.LearnerConfig(algo="linear_sgd", dim=18)
    else:
        jl, tl = _jcfg_tcfg(budget=1024, dim=18)
    js, ts = jsub.substrate_of(jl), tsub.substrate_of(tl)
    lo, hi = 2, 1 << 26
    while hi - lo > 1:           # the first m the reference refuses
        mid = (lo + hi) // 2
        try:
            jeng._allreduce_cost(js, mid)
            lo = mid
        except ValueError:
            hi = mid
    assert teng.allreduce_cost(ts, lo) == int(jeng._allreduce_cost(js, lo))
    with pytest.raises(ValueError):
        teng.allreduce_cost(ts, hi)


# ---------------------------------------------------------------------------
# token_stream and the public names completed with the protocol slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,seq", [(0, 512, 16), (3, 151936, 33)])
def test_token_stream_byte_identical(seed, vocab, seq):
    from repro.data import token_stream as jtok
    from repro_torch.data import token_stream as ttok

    got = list(ttok(4, 2, seq, vocab, seed=seed))
    want = list(jtok(4, 2, seq, vocab, seed=seed))
    assert len(got) == len(want) == 4
    for (gt, gl), (wt, wl) in zip(got, want):
        for a, b in ((gt, wt), (gl, wl)):
            assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_diag_norm_sq_num_active_match(kind, backend_parity):
    js, ts = _spec_pair(kind)
    sv, alpha, ids = _stacked(11, 3, 9, 4)
    X = np.random.default_rng(12).normal(size=(7, 4)).astype(np.float32)
    backend_parity(_np(trkhs.kernel_diag(ts, torch.as_tensor(X))),
                   jrkhs.kernel_diag(js, jnp.asarray(X)), "kernel_diag")
    jm, tm = _jmodel(sv, alpha, ids), _tmodel(sv, alpha, ids)
    backend_parity(_np(trkhs.norm_sq(ts, tm)),
                   jax.vmap(lambda f: jrkhs.norm_sq(js, f))(jm), "norm_sq")
    got = trkhs.num_active(tm)
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(jax.vmap(jrkhs.num_active)(jm)))
    one = jrkhs.SVModel(*(x[0] for x in jm))
    assert int(trkhs.num_active(type(tm)(*(x[0] for x in tm)))) == \
        int(jrkhs.num_active(one))


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_rff_make_update_matches(loss, backend_parity):
    from repro.core import rff as jrff
    from repro_torch.core import rff as trff

    jspec = jrff.RFFSpec(dim=6, num_features=64, gamma=0.3, seed=2)
    W, b = jrff.rff_params(jspec)
    tspec = convert.rff_spec(jspec, W, b)
    tW, tb = trff.rff_params(tspec)
    jup = jax.jit(jrff.make_update(jspec, W, b, eta=0.3, lam=0.02, loss=loss))
    tup = trff.make_update(tspec, tW, tb, eta=0.3, lam=0.02, loss=loss)
    js, ts = jrff.init_state(jspec), trff.init_state(tspec)
    X, Y = jstreams.susy_stream(12, 1, d=6, seed=4)
    for t in range(12):
        js, jl = jup(js, (jnp.asarray(X[t, 0]), jnp.asarray(Y[t, 0])))
        ts, tl = tup(ts, (torch.as_tensor(X[t, 0]), torch.as_tensor(Y[t, 0])))
        backend_parity(_np(tl), jl, f"loss {t}")
        backend_parity(_np(ts.w), js.w, f"w {t}")
        backend_parity(_np(ts.b), js.b, f"b {t}")


def test_truncation_error_bound_and_learner_axes_of():
    for lam, tau in ((0.1, 10), (0.01, 1000), (0.5, 1)):
        assert tcomp.truncation_error_bound(lam, tau) == \
            jcomp.truncation_error_bound(lam, tau)
    from repro_torch.launch import mesh as tmesh

    assert teng.learner_axes_of is tmesh.learner_axes_of
    mesh = tmesh.make_learner_mesh(devices=["cpu"] * 2)
    assert teng.learner_axes_of(mesh) == ("learners",)
