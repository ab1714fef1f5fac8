"""The port's protocol operators against the JAX package's, on the CPU.

``repro_torch.core.protocol`` and ``repro.core.protocol`` get the same
numpy-made stacked pytrees (a dict, a list and a NamedTuple, m = 4,
float32).  Every operator is held to the reference within the suite's
parity pair (tests/conftest.py); ``apply_protocol`` runs 8 rounds of
seeded drift under every kind x stacked or un-stacked reference x
``delta_schedule`` x ``per_group`` x ``mini_batch``, with ``syncs``,
``bytes_sent`` and ``step`` equal every round.  Then the Sec. 4
controller of benchmarks/bench_adaptive.py (its five configs, 200
rounds) through both packages' ``make_protocol_step``, and the ports of
tests/test_protocol.py and of the protocol properties of
tests/test_property.py (seeded draws: hypothesis is optional here).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.core import protocol as jproto
from repro.data import drifting_stream

from repro_torch import convert
from repro_torch.core import protocol
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.tree import tree_map

M = 4


class Pair(NamedTuple):
    a: object
    b: object


def _np_tree(kind, m=M, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return (rng.normal(size=(m,) + shape) * scale).astype(np.float32)

    if kind == "dict":
        return {"w": arr(6), "b": arr()}
    if kind == "list":
        return [arr(3, 2), arr(5)]
    return Pair(a=arr(4), b=arr(2, 2))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(fn(v) for v in tree))
    return [fn(v) for v in tree]


def _j(tree):
    return _map(jnp.asarray, tree)


def _t(tree):
    return _map(torch.as_tensor, tree)


def _close(got, want, label):
    got = convert.to_numpy(got)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), label
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w, np.float32),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=label)


KINDS = ("dict", "list", "namedtuple")


def _same_float32(got, want) -> bool:
    """The float32 carry bit for bit (the reference keeps ``bytes_sent``
    in float32 with x64 off)."""
    got = np.asarray(convert.to_numpy(got), np.float32)
    want = np.asarray(want, np.float32)
    return got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Operators against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_operators_match_reference(kind):
    st = _np_tree(kind)
    ref_stacked = _np_tree(kind, seed=5, scale=0.5)
    ref_one = _map(lambda x: x[0], _np_tree(kind, seed=6, scale=0.5))
    js, ts = _j(st), _t(st)
    _close(protocol.average_model(ts), jproto.average_model(js), "average")
    _close(protocol.broadcast_model(_t(ref_one), M),
           jproto.broadcast_model(_j(ref_one), M), "broadcast")
    for ref in (ref_stacked, ref_one):
        _close(protocol._sq_dist_to(ts, _t(ref)),
               jproto._sq_dist_to(js, _j(ref)), "sq_dist_to")
        d = np.asarray(jproto._sq_dist_to(js, _j(ref)))
        for delta in (float(np.min(d)) * 0.5, float(np.median(d)),
                      float(np.max(d)) * 2.0):
            assert np.array_equal(
                protocol.local_conditions(ts, _t(ref), delta).numpy(),
                np.asarray(jproto.local_conditions(js, _j(ref), delta)))
            assert np.array_equal(
                protocol.group_local_conditions(ts, _t(ref), delta).numpy(),
                np.asarray(jproto.group_local_conditions(js, _j(ref), delta)))
    _close(protocol.divergence(ts), jproto.divergence(js), "divergence")
    assert protocol.model_num_params(ts) == jproto.model_num_params(js)
    assert protocol.model_bytes(ts) == jproto.model_bytes(js)
    _close(protocol.sigma_continuous(ts), jproto.sigma_continuous(js),
           "sigma_continuous")
    for step in (3, 4):
        _close(protocol.sigma_periodic(ts, torch.tensor(step, dtype=torch.int32), 2),
               jproto.sigma_periodic(js, jnp.asarray(step, jnp.int32), 2),
               "sigma_periodic")
    ref = _map(lambda x: x[0], ref_stacked)
    for delta in (1e-9, 1e9):
        got = protocol.sigma_dynamic(ts, _t(ref), delta)
        want = jproto.sigma_dynamic(js, _j(ref), delta)
        assert bool(got[2]) == bool(want[2])
        _close(got[0], want[0], "sigma_dynamic stacked")
        _close(got[1], want[1], "sigma_dynamic reference")


def test_protocol_config_fields_defaults_and_errors():
    got, want = ProtocolConfig(), jproto.ProtocolConfig()
    for f in ("kind", "period", "delta", "mini_batch", "per_group",
              "delta_schedule", "target_sync_rate", "adapt_up"):
        assert getattr(got, f) == getattr(want, f), f
    assert ProtocolConfig(kind="dynamic", delta=1.0) == \
        ProtocolConfig(kind="dynamic", delta=1.0)
    assert hash(ProtocolConfig(delta_schedule="sqrt")) == \
        hash(ProtocolConfig(delta_schedule="sqrt"))
    for kw in (dict(kind="gossip"), dict(period=0), dict(delta=-1.0),
               dict(delta_schedule="cosine"), dict(target_sync_rate=0.0),
               dict(target_sync_rate=1.0)):
        with pytest.raises(ValueError):
            ProtocolConfig(**kw)
        with pytest.raises(ValueError):
            jproto.ProtocolConfig(**kw)


def test_init_state_types_match_reference():
    one = _map(lambda x: x[0], _np_tree("dict"))
    got = protocol.init_state(_t(one), M)
    want = jproto.init_state(_j(one), M)
    assert got.step.dtype == torch.int32 and got.syncs.dtype == torch.int32
    assert got.bytes_sent.dtype == torch.float32
    assert got.last_divergence.dtype == torch.float32
    assert got.delta_scale.dtype == torch.float32
    assert float(got.delta_scale) == float(want.delta_scale) == 1.0
    _close(got.reference, want.reference, "stacked reference")
    flat = protocol.init_state(_t(one), M, stacked_reference=False)
    assert flat.reference["w"].shape == (6,)
    assert protocol.ProtocolState(None, 0, 0, 0.0, 0.0).delta_scale == 1.0


# ---------------------------------------------------------------------------
# apply_protocol over every configuration
# ---------------------------------------------------------------------------

CASES = [(kind, stacked_ref, sched, per_group, mb)
         for kind in ("none", "continuous", "periodic", "dynamic")
         for stacked_ref in (True, False)
         for sched in ("const", "sqrt", "adaptive")
         for per_group in (False, True)
         for mb in (1, 3)]


@pytest.mark.parametrize("kind,stacked_ref,sched,per_group,mb", CASES)
def test_apply_protocol_matches_reference(kind, stacked_ref, sched,
                                          per_group, mb):
    tree = KINDS[CASES.index((kind, stacked_ref, sched, per_group, mb)) % 3]
    cfg = dict(kind=kind, period=3, delta=1.5, mini_batch=mb,
               per_group=per_group, delta_schedule=sched,
               target_sync_rate=0.3, adapt_up=1.5)
    tcfg, jcfg = ProtocolConfig(**cfg), jproto.ProtocolConfig(**cfg)
    japply = jax.jit(lambda st, state: jproto.apply_protocol(jcfg, st, state))
    zeros = _map(lambda x: x * 0.0, _np_tree(tree))
    one = _map(lambda x: x[0], zeros)
    tstate = protocol.init_state(_t(one), M, stacked_reference=stacked_ref)
    jstate = jproto.init_state(_j(one), M, stacked_reference=stacked_ref)
    ts, js = _t(zeros), _j(zeros)
    syncs = []
    for t in range(8):
        noise = _np_tree(tree, seed=100 + t, scale=0.3)
        ts = tree_map(lambda a, n: a + n, ts, _t(noise))
        js = jax.tree.map(lambda a, n: a + n, js, _j(noise))
        ts, tstate = protocol.apply_protocol(tcfg, ts, tstate)
        js, jstate = japply(js, jstate)
        label = f"round {t + 1}"
        assert int(tstate.step) == int(jstate.step) == t + 1, label
        assert int(tstate.syncs) == int(jstate.syncs), label
        assert tstate.bytes_sent.dtype == torch.float32
        assert _same_float32(tstate.bytes_sent, jstate.bytes_sent), label
        _close(tstate.last_divergence, jstate.last_divergence, label)
        _close(tstate.delta_scale, jstate.delta_scale, label)
        _close(ts, js, label)
        _close(tstate.reference, jstate.reference, label)
        syncs.append(int(tstate.syncs))
    if kind == "dynamic":
        # the drift and the threshold give sync rounds and quiet rounds
        assert 0 < syncs[-1] < 8 and syncs[-1] <= 8 // mb, syncs


def test_sync_charge_is_float32_of_the_host_int():
    """The charge meets the float32 carry as float32(2 m |model|), the
    reference's value wherever the reference runs (below 2^31)."""
    st = {"w": torch.zeros((2, 3))}
    state = protocol.init_state({"w": torch.zeros(3)}, 2)
    big = 24_700_000_000
    cfg = ProtocolConfig(kind="periodic", period=1)
    for t in range(3):
        st, state = protocol.apply_protocol(cfg, st, state, bytes_per_sync=big)
    want = np.float32(0)
    for _ in range(3):
        want = np.float32(want + np.float32(big))
    assert _same_float32(state.bytes_sent, want)
    with pytest.raises(OverflowError):
        jproto.apply_protocol(jproto.ProtocolConfig(kind="periodic"),
                              {"w": jnp.zeros((2, 3))},
                              jproto.init_state({"w": jnp.zeros(3)}, 2),
                              bytes_per_sync=big)


# ---------------------------------------------------------------------------
# benchmarks/bench_adaptive.py's Sec. 4 controller
# ---------------------------------------------------------------------------

ADAPTIVE = [
    dict(kind="dynamic", delta=1e-3),
    dict(kind="dynamic", delta=1e1),
    dict(kind="dynamic", delta=1e-3, delta_schedule="adaptive",
         target_sync_rate=0.10, adapt_up=2.0),
    dict(kind="dynamic", delta=1e1, delta_schedule="adaptive",
         target_sync_rate=0.10, adapt_up=2.0),
    dict(kind="dynamic", delta=5.0, delta_schedule="sqrt"),
]


def _hinge_update(model, ex):
    x, y = ex
    pred = model["w"] @ x
    ell = torch.clamp(1.0 - y * pred, min=0.0)
    g = torch.where(ell > 0, -y, torch.zeros_like(y))
    return {"w": model["w"] - 0.2 * g * x}, ell


def _jax_hinge_update(model, ex):
    x, y = ex
    pred = model["w"] @ x
    ell = jnp.maximum(0.0, 1.0 - y * pred)
    g = jnp.where(ell > 0, -y, 0.0)
    return {"w": model["w"] - 0.2 * g * x}, ell


@pytest.mark.parametrize("cfg", ADAPTIVE, ids=lambda c: str(sorted(c.items())))
def test_bench_adaptive_controller_matches_reference(cfg):
    T, m, d = 200, 4, 8
    X, Y = drifting_stream(T, m, d=d, seed=0, drift_every=T // 4)
    jstep = jax.jit(jproto.make_protocol_step(jproto.ProtocolConfig(**cfg),
                                              _jax_hinge_update))
    tstep = protocol.make_protocol_step(ProtocolConfig(**cfg), _hinge_update)
    jst, jstate = {"w": jnp.zeros((m, d))}, jproto.init_state(
        {"w": jnp.zeros((d,))}, m)
    tst, tstate = {"w": torch.zeros((m, d))}, protocol.init_state(
        {"w": torch.zeros((d,))}, m)
    jloss = tloss = 0.0
    for t in range(T):
        jst, jstate, jl = jstep(jst, jstate, (jnp.asarray(X[t]),
                                              jnp.asarray(Y[t])))
        tst, tstate, tl = tstep(tst, tstate, (torch.as_tensor(X[t]),
                                              torch.as_tensor(Y[t])))
        assert int(tstate.syncs) == int(jstate.syncs), t
        jloss += float(jl)
        tloss += float(tl)
    assert _same_float32(tstate.bytes_sent, jstate.bytes_sent)
    assert int(tstate.step) == int(jstate.step) == T
    np.testing.assert_allclose(tloss, jloss, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL)
    _close(tstate.delta_scale, jstate.delta_scale, "delta_scale")


# ---------------------------------------------------------------------------
# Ports of tests/test_protocol.py
# ---------------------------------------------------------------------------


def _stacked(m=4, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32),
            "b": torch.as_tensor(rng.normal(size=(m,)), dtype=torch.float32)}


def _first(st):
    return {k: v[0] for k, v in st.items()}


def test_average_model():
    st = _stacked()
    avg = protocol.average_model(st)
    np.testing.assert_allclose(avg["w"], np.mean(st["w"].numpy(), 0),
                               rtol=1e-6)


def test_sigma_continuous_sets_all_to_average():
    st = _stacked()
    out = protocol.sigma_continuous(st)
    avg = protocol.average_model(st)
    for i in range(4):
        np.testing.assert_allclose(out["w"][i], avg["w"], rtol=1e-6)
    np.testing.assert_allclose(protocol.average_model(out)["w"], avg["w"],
                               rtol=1e-6)


def test_divergence_zero_after_sync():
    st = _stacked()
    out = protocol.sigma_continuous(st)
    assert float(protocol.divergence(out)) < 1e-10
    assert float(protocol.divergence(st)) > 0.0


def test_local_conditions_imply_divergence_bound():
    rng = np.random.default_rng(1)
    for trial in range(20):
        m, d = 5, 4
        st = {"w": torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32)}
        ref = {"w": torch.as_tensor(rng.normal(size=(d,)), dtype=torch.float32)}
        delta = float(rng.uniform(0.5, 10.0))
        violated = protocol.local_conditions(st, ref, delta)
        if not bool(torch.any(violated)):
            assert float(protocol.divergence(st)) <= delta + 1e-6


def test_dynamic_no_sync_below_threshold():
    st = _stacked()
    ref = protocol.average_model(st)
    out, new_ref, synced = protocol.sigma_dynamic(st, ref, delta=1e9)
    assert not bool(synced)
    np.testing.assert_allclose(out["w"], st["w"])


def test_dynamic_sync_on_violation():
    st = _stacked()
    ref = protocol.average_model(st)
    out, new_ref, synced = protocol.sigma_dynamic(st, ref, delta=1e-9)
    assert bool(synced)
    avg = protocol.average_model(st)
    for i in range(4):
        np.testing.assert_allclose(out["w"][i], avg["w"], rtol=1e-6)
    np.testing.assert_allclose(new_ref["w"], avg["w"], rtol=1e-6)


@pytest.mark.parametrize("kind,period", [("continuous", 1), ("periodic", 3)])
def test_apply_protocol_schedules(kind, period):
    cfg = ProtocolConfig(kind=kind, period=period)
    st = _stacked()
    state = protocol.init_state(_first(st), 4)
    for t in range(6):
        st = _stacked(seed=t + 10)
        st, state = protocol.apply_protocol(cfg, st, state)
    assert int(state.syncs) == (6 if kind == "continuous" else 2)


def test_apply_protocol_counts_bytes():
    cfg = ProtocolConfig(kind="continuous")
    st = _stacked(m=4, d=6)
    state = protocol.init_state(_first(st), 4)
    _, state = protocol.apply_protocol(cfg, st, state)
    assert int(state.bytes_sent) == 2 * 4 * (7 * 4)


def test_stacked_reference_mode():
    st = _stacked()
    state = protocol.init_state(_first(st), 4, stacked_reference=True)
    assert state.reference["w"].shape[0] == 4
    cfg = ProtocolConfig(kind="dynamic", delta=1e-9)
    out, new_state = protocol.apply_protocol(cfg, st, state)
    avg = protocol.average_model(st)
    for i in range(4):
        np.testing.assert_allclose(new_state.reference["w"][i], avg["w"],
                                   rtol=1e-6)


def test_mini_batch_peak_communication_guard():
    cfg = ProtocolConfig(kind="dynamic", delta=1e-12, mini_batch=3)
    st = _stacked()
    state = protocol.init_state(_first(st), 4)
    sync_rounds = []
    for t in range(9):
        st = _stacked(seed=t)
        st, state = protocol.apply_protocol(cfg, st, state)
        sync_rounds.append(int(state.syncs))
    assert sync_rounds[-1] <= 3
    assert sync_rounds == [0, 0, 1, 1, 1, 2, 2, 2, 3]


def test_make_protocol_step_runs_and_reduces_divergence():
    cfg = ProtocolConfig(kind="dynamic", delta=0.5)

    def local_update(model, ex):
        x, y = ex
        err = model["w"] @ x - y
        return {"w": model["w"] - 0.1 * err * x}, 0.5 * err * err

    step = protocol.make_protocol_step(cfg, local_update)
    m, d = 4, 3
    st = {"w": torch.zeros((m, d))}
    state = protocol.init_state({"w": torch.zeros((d,))}, m)
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(d,))
    for t in range(100):
        X = rng.normal(size=(m, d)).astype(np.float32)
        Y = (X @ w_true).astype(np.float32)
        st, state, loss = step(st, state, (torch.as_tensor(X),
                                           torch.as_tensor(Y)))
    assert float(loss) < 0.1
    assert float(protocol.divergence(st)) < 0.5 + 1e-5


def test_sqrt_delta_schedule_tightens_over_time():
    cfg = ProtocolConfig(kind="dynamic", delta=4.0, delta_schedule="sqrt")
    state = protocol.init_state({"w": torch.zeros((4,))}, 3)
    drifted = {"w": torch.ones((3, 4)) * torch.tensor([[1.], [0.], [-1.]])}
    out1, state = protocol.apply_protocol(cfg, drifted, state)
    assert int(state.syncs) == 0
    state = state._replace(step=torch.tensor(15, dtype=torch.int32))
    out2, state = protocol.apply_protocol(cfg, drifted, state)
    assert int(state.syncs) == 1


def test_adaptive_threshold_reaches_target_sync_rate():
    rng = np.random.default_rng(0)
    for delta0 in (1e-6, 1e2):
        cfg = ProtocolConfig(kind="dynamic", delta=delta0,
                             delta_schedule="adaptive",
                             target_sync_rate=0.2, adapt_up=1.5)
        m, d = 4, 6
        st = {"w": torch.zeros((m, d))}
        state = protocol.init_state({"w": torch.zeros((d,))}, m)
        T = 400
        for t in range(T):
            st = {"w": st["w"] + torch.as_tensor(
                rng.normal(size=(m, d)) * 0.3, dtype=torch.float32)}
            st, state = protocol.apply_protocol(cfg, st, state)
        rate = int(state.syncs) / T
        assert 0.08 < rate < 0.45, (delta0, rate)


def test_per_group_conditions_catch_concentrated_drift():
    m = 3
    st = {"big": torch.zeros((m, 1000)), "small": torch.zeros((m, 10))}
    ref = {"big": torch.zeros((m, 1000)), "small": torch.zeros((m, 10))}
    st["small"] = st["small"].clone()
    st["small"][0] = float(np.sqrt(np.float32(0.09)))
    glob = protocol.local_conditions(st, ref, 1.0)
    assert not bool(torch.any(glob))
    per = protocol.group_local_conditions(st, ref, 1.0)
    assert bool(per[0])
    st2 = {"big": torch.zeros((m, 1000)), "small": torch.zeros((m, 10))}
    assert not bool(torch.any(protocol.group_local_conditions(st2, ref, 1.0)))


def test_per_group_protocol_round():
    cfg = ProtocolConfig(kind="dynamic", delta=1.0, per_group=True)
    m = 3
    st = {"big": torch.zeros((m, 100)), "small": torch.ones((m, 4)) * 0.5}
    state = protocol.init_state({"big": torch.zeros(100),
                                 "small": torch.zeros(4)}, m)
    out, new_state = protocol.apply_protocol(cfg, st, state)
    assert int(new_state.syncs) == 1


# ---------------------------------------------------------------------------
# Ports of the protocol properties of tests/test_property.py:24-56
# ---------------------------------------------------------------------------

DRAWS = 25


def _draw(rng, m, d):
    return {"w": torch.as_tensor(rng.uniform(-3.0, 3.0, size=(m, d)),
                                 dtype=torch.float32)}


def test_sync_preserves_mean():
    rng = np.random.default_rng(11)
    for _ in range(DRAWS):
        st_ = _draw(rng, 4, 5)
        out = protocol.sigma_continuous(st_)
        np.testing.assert_allclose(protocol.average_model(out)["w"],
                                   protocol.average_model(st_)["w"],
                                   rtol=1e-5, atol=1e-6)


def test_divergence_nonnegative_and_zero_after_sync():
    rng = np.random.default_rng(12)
    for _ in range(DRAWS):
        st_ = _draw(rng, 4, 5)
        assert float(protocol.divergence(st_)) >= -1e-6
        assert float(protocol.divergence(protocol.sigma_continuous(st_))) < 1e-8


def test_no_violation_implies_divergence_below_delta():
    rng = np.random.default_rng(13)
    held = 0
    for _ in range(DRAWS * 4):
        st_ = _draw(rng, 5, 4)
        delta = float(rng.uniform(0.01, 100.0))
        ref = protocol.average_model(st_)
        if not bool(torch.any(protocol.local_conditions(st_, ref, delta))):
            held += 1
            assert float(protocol.divergence(st_)) <= delta * (1 + 1e-5) + 1e-6
    assert held > 0
