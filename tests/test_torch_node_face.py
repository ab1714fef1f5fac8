"""The substrates' node face and the payload sizing of the port against
the JAX package (``repro.core.substrate`` / ``repro.core.accounting``).

Each family (SV, RFF, linear) at a small size, below the kernel
threshold, and SV and RFF at an engaged size (SV budget 130, RFF D 256)
with ``backend="kernels"`` on the port (on the CPU its wrappers take the
plain versions) and ``backend="pallas"`` on the reference (the Pallas
kernels in interpret mode).  Both sides work on the same states: the
reference's, trained for a few rounds, carried across by ``convert``.
The contract:

- byte counts and id sets equal;
- floats within the suite's one parity pair (``backend_parity``);
- the primal aggregate bitwise the reference's (the same float64
  operations in the same order on the same floats);
- the SV aggregate with every weight 1 bitwise the port's own
  ``average_stacked`` compressed: the same kept slots in the same order
  with the same floats.
"""
import numpy as np
import pytest

from repro.core import accounting as jacc
from repro.core import rff as jrff
from repro.core import substrate as jsub_mod
from repro.core.learners import LearnerConfig as JLearner
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import susy_stream
from repro.runtime.async_protocol import AsyncProtocolConfig as JAsync
from repro.runtime.async_protocol import staleness_weight as jstale

import torch

from repro_torch import convert
from repro_torch.core import accounting as tacc
from repro_torch.core import learners as tlearners
from repro_torch.core import substrate as tsub_mod
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.rkhs import KernelSpec as TKernel
from repro_torch.kernels import ops
from repro_torch.runtime.async_protocol import AsyncProtocolConfig as TAsync
from repro_torch.runtime.async_protocol import staleness_weight as tstale
from repro_torch.runtime.transport import kernel_payload_bytes

D_IN = 6
CPU = torch.device("cpu")


def _subs(family, size):
    """(reference substrate, port substrate) for one family and size."""
    engaged = size == "engaged"
    jb, tb = ("pallas", "kernels") if engaged else ("reference", "reference")
    if family == "sv":
        common = dict(algo="kernel_sgd", budget=130 if engaged else 12,
                      dim=D_IN)
        return (jsub_mod.substrate_of(
                    JLearner(kernel=JKernel("gaussian", gamma=0.3), **common),
                    backend=jb),
                tsub_mod.substrate_of(
                    TLearner(kernel=TKernel("gaussian", gamma=0.3), **common),
                    backend=tb))
    if family == "rff":
        js = JRFFSpec(dim=D_IN, num_features=256 if engaged else 32,
                      gamma=0.3, seed=0)
        W, b = jrff.rff_params(js)
        return (jsub_mod.substrate_of(js, backend=jb),
                tsub_mod.substrate_of(convert.rff_spec(js, W, b),
                                      backend=tb))
    common = dict(algo="linear_sgd", dim=D_IN)
    return (jsub_mod.substrate_of(JLearner(**common)),
            tsub_mod.substrate_of(TLearner(**common)))


def _to_port(family, state):
    if family == "sv":
        return convert.kernel_learner_state(state, CPU)
    if family == "rff":
        return convert.rff_state(state, CPU)
    return convert.linear_state(state, CPU)


def _model_to_port(family, model):
    return (convert.sv_model(model, CPU) if family == "sv"
            else _to_port(family, model))


def _same(got, want, backend_parity, label):
    """Field by field: ids and counters equal, floats within parity."""
    for name, g, w in zip(want._fields, got, want):
        if hasattr(w, "_fields"):
            _same(g, w, backend_parity, f"{label}.{name}")
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{label}.{name}")
        else:
            backend_parity(g, w, f"{label}.{name}")


def _trained(jsub, idx, rounds, seed):
    """A reference node state after ``rounds`` rounds on a seeded stream."""
    X, Y = susy_stream(rounds, 1, d=D_IN, seed=seed)
    ops_j = jsub_mod.node_ops(jsub)
    state = jsub.init_node(idx)
    for t in range(rounds):
        state, _, _ = ops_j.round(state, (X[t, 0], Y[t, 0]))
    return state


FACES = [("sv", "small"), ("sv", "engaged"), ("rff", "small"),
         ("rff", "engaged"), ("linear", "small")]


@pytest.mark.parametrize("family,size", FACES)
def test_node_face_matches_reference(family, size, backend_parity):
    jsub, tsub = _subs(family, size)
    bm_j, bm_t = jacc.ByteModel(dim=D_IN), tacc.ByteModel(dim=D_IN)
    rounds = 25 if family == "sv" else 12
    js = [_trained(jsub, i, rounds, seed=i) for i in range(3)]
    ts = [_to_port(family, s) for s in js]
    jmodels = [jsub.node_model(s) for s in js]
    tmodels = [tsub.node_model(s) for s in ts]
    tsub_ops = tsub_mod.node_ops(tsub)
    ops.reset_launch_counts()

    # fresh nodes and the first reference
    for idx in (0, 2):
        _same(tsub.init_node(idx, CPU), jsub.init_node(idx), backend_parity,
              f"init_node {idx}")
    jref0, tref0 = jsub.init_reference(), tsub.init_reference(CPU)
    _same(tref0, jref0, backend_parity, "init_reference")

    # a reference with content: a staleness-weighted aggregate
    weights = [0.6, 0.8, 0.3]
    jref, jeps, junion = jsub.aggregate(jref0, jmodels, weights)
    tref, teps, tunion = tsub.aggregate(tref0, tmodels, weights)
    assert tunion == junion
    if family == "sv":
        backend_parity(teps, jeps, "aggregate eps")
    else:
        assert teps is None and jeps is None
    if family == "sv":
        _same(tref, jref, backend_parity, "aggregate")
    else:        # float64 in arrival order on the same floats: bitwise
        assert np.array_equal(tref.w.numpy(), np.asarray(jref.w))
        assert np.array_equal(tref.b.numpy(), np.asarray(jref.b))
    # the rest of the checks hold the port's reference equal to JAX's
    tref = _model_to_port(family, jref)
    # a second aggregate against the first's reference, in another order
    jref2, _, junion2 = jsub.aggregate(jref, jmodels[::-1], [1.0, 0.5, 0.9])
    tref2, _, tunion2 = tsub.aggregate(tref, tmodels[::-1], [1.0, 0.5, 0.9])
    assert tunion2 == junion2
    _same(tref2, jref2, backend_parity, "aggregate against a reference")

    X, Y = susy_stream(4, 1, d=D_IN, seed=9)
    for t in range(4):
        xj, yj = X[t, 0], Y[t, 0]
        xt, yt = torch.as_tensor(xj), torch.as_tensor(yj)
        for i in range(3):
            backend_parity(tsub.predict_one(tmodels[i], xt).numpy(),
                           np.asarray(jsub.predict_one(jmodels[i], xj)),
                           f"predict_one {i}")
            new_t, loss_t = tsub.update_one(ts[i], (xt, yt))
            new_j, loss_j = jsub.update_one(js[i], (xj, yj))
            _same(new_t, new_j, backend_parity, f"update_one {i}")
            backend_parity(loss_t.numpy(), np.asarray(loss_j), "loss")
            rnd_t = tsub_ops.round(ts[i], (xt, yt))
            rnd_j = jsub_mod.node_ops(jsub).round(js[i], (xj, yj))
            _same(rnd_t[0], rnd_j[0], backend_parity, f"round {i}")
            for g, w in zip(rnd_t[1:], rnd_j[1:]):
                backend_parity(g.numpy(), np.asarray(w), "round loss, yhat")
    for i in range(3):
        backend_parity(tsub.dist_one(tmodels[i], tref).numpy(),
                       np.asarray(jsub.dist_one(jmodels[i], jref)),
                       f"dist_one {i}")
        _same(tsub.adopt_node(ts[i], tref), jsub.adopt_node(js[i], jref),
              backend_parity, f"adopt_node {i}")

    # payloads: the model shipped, its ids and its bytes
    known = set(sorted(junion)[::2])
    for i in range(3):
        jm, jids, jn = jsub.upload_payload(bm_j, js[i], known)
        tm, tids, tn = tsub.upload_payload(bm_t, ts[i], known)
        assert (tids, tn) == (jids, jn)
        _same(tm, jm, backend_parity, f"upload {i}")
        assert (tsub.download_payload_bytes(bm_t, junion, tids)
                == jsub.download_payload_bytes(bm_j, junion, jids))

    # snapshots: host buffers, then the round-indexed divergence series
    jb, tb = jsub.snapshot_buffers(2, 3), tsub.snapshot_buffers(2, 3)
    assert {k: (v.shape, v.dtype) for k, v in tb.items()} == \
        {k: (v.shape, v.dtype) for k, v in jb.items()}
    for t in range(2):
        for i in range(3):
            jsub.write_snapshot(jb, t, i, jmodels[(i + t) % 3])
            tsub.write_snapshot(tb, t, i, tmodels[(i + t) % 3])
    for k in jb:
        backend_parity(tb[k], jb[k], f"snapshot {k}")
    backend_parity(tsub.divergence_series(tb, CPU),
                   jsub.divergence_series(jb), "divergence_series")
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU run launched a kernel"


@pytest.mark.parametrize("size", ["small", "engaged"])
def test_sv_aggregate_at_full_weight_is_the_average(size):
    """With every weight 1 the reference's slots enter with coefficient
    exactly 0 and are pruned: the mix holds ``average_stacked``'s active
    slots in its order with its floats, and compresses to its model
    bitwise; the union is the stack's id set."""
    _, tsub = _subs("sv", size)
    js, _ = _subs("sv", size)
    rounds = 40 if size == "engaged" else 25     # the union outgrows tau
    states = [_to_port("sv", _trained(js, i, rounds, seed=i))
              for i in range(4)]
    models = [s.model for s in states]
    stacked = type(models[0])(*(torch.stack(v) for v in zip(*models)))
    ref = tsub.aggregate(tsub.init_reference(CPU), models, [0.7] * 4)[0]
    fsync, _, union = tsub.aggregate(ref, models, [1.0] * 4)
    want, _ = tsub.average_stacked(stacked)
    for g, w in zip(fsync, want):
        assert torch.equal(g, w)
    assert union == tacc.idset(stacked.sv_id.numpy())
    assert len(union) > tsub.sync_budget


def test_payload_bytes_match_reference():
    rng = np.random.default_rng(0)
    for dim in (1, 6, 18):
        jbm, tbm = jacc.ByteModel(dim=dim), tacc.ByteModel(dim=dim)
        for _ in range(20):
            send = set(int(i) for i in rng.choice(300, rng.integers(0, 60),
                                                  replace=False))
            known = set(int(i) for i in rng.choice(300, rng.integers(0, 60),
                                                   replace=False))
            got = tacc.kernel_payload_bytes(tbm, send, known)
            assert got == jacc.kernel_payload_bytes(jbm, send, known)
            assert isinstance(got, int)
    for p in (1, 19, 2049):
        for b in (2, 4, 8):
            assert (tacc.linear_payload_bytes(p, b)
                    == jacc.linear_payload_bytes(p, b))
    assert tacc.linear_payload_bytes(19) == jacc.linear_payload_bytes(19)


def test_delta_encoding_matches_accounting():
    """Per-message transport costs summed over one full synchronization
    reproduce accounting.sync_bytes_kernel to the byte (the reference's
    tests/test_runtime.py case, on the port)."""
    bm = tacc.ByteModel(dim=8)
    rng = np.random.default_rng(0)
    known = set(int(i) for i in rng.choice(200, 30, replace=False))
    local_ids = [rng.choice(200, size=rng.integers(5, 40), replace=False)
                 for _ in range(4)]
    expect, union = tacc.sync_bytes_kernel(bm, local_ids, known)
    sets = [set(int(i) for i in ids) for ids in local_ids]
    total = sum(kernel_payload_bytes(bm, s, known) for s in sets)
    total += sum(kernel_payload_bytes(bm, union, s) for s in sets)
    assert total == expect


def test_staleness_schedules_and_learner_faces_match_reference():
    for kw in (dict(staleness="constant"),
               dict(staleness="hinge", stale_a=0.5, stale_b=4),
               dict(staleness="hinge", stale_a=2.0, stale_b=0),
               dict(staleness="poly", stale_a=0.5),
               dict(staleness="poly", stale_a=1.7)):
        jc, tc = JAsync(**kw), TAsync(**kw)
        assert [tstale(tc, lag) for lag in range(-2, 40)] == \
            [jstale(jc, lag) for lag in range(-2, 40)]
    for bad in (dict(kind="sometimes"), dict(staleness="linear"),
                dict(alpha=0.0), dict(alpha=1.5), dict(period=0),
                dict(mini_batch=0), dict(staleness="poly", stale_a=0.0),
                dict(agg_window=-1.0)):
        with pytest.raises(ValueError):
            JAsync(**bad)
        with pytest.raises(ValueError):
            TAsync(**bad)
    from repro.core.learners import gamma_of as jgamma
    for kw in (dict(algo="kernel_sgd", eta=0.3), dict(algo="kernel_pa", C=0.4),
               dict(algo="linear_pa", C=3.0), dict(algo="linear_sgd")):
        assert tlearners.gamma_of(TLearner(**kw)) == jgamma(JLearner(**kw))
