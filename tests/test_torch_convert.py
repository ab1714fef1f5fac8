"""``repro_torch.convert``: a reference state carried across to the port
gives the same next round.

The reference substrate runs k stacked rounds (and one sync) on the
JAX side; its state, its synchronized model and, for RFF, its
``(W, b)`` draw are converted, and one more round on each side must
agree: ids and counters equal, floats within the suite's parity
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rff as jrff
from repro.core import substrate as jsub
from repro.core.learners import LearnerConfig as JLearner
from repro.core.rff import RFFSpec as JRFFSpec
from repro.core.rkhs import KernelSpec as JKernel
from repro.data.streams import susy_stream

from repro_torch import convert
from repro_torch.core import substrate as tsub
from repro_torch.core.learners import LearnerConfig as TLearner
from repro_torch.core.rkhs import KernelSpec as TKernel

D_IN, M, K = 6, 3, 9


def _pair(family, backend):
    jb = "pallas" if backend == "kernels" else backend
    if family == "sv":
        kw = dict(algo="kernel_sgd", budget=5, dim=D_IN)
        return (jsub.SVSubstrate(lcfg=JLearner(kernel=JKernel(gamma=0.4), **kw),
                                 backend=jb),
                tsub.SVSubstrate(lcfg=TLearner(kernel=TKernel(gamma=0.4), **kw),
                                 backend=backend), convert.kernel_learner_state)
    if family == "rff":
        js = JRFFSpec(dim=D_IN, num_features=24, gamma=0.4, seed=3)
        W, b = jrff.rff_params(js)
        return (jsub.RFFSubstrate(spec=js, backend=jb),
                tsub.RFFSubstrate(spec=convert.rff_spec(js, W, b),
                                  backend=backend), convert.rff_state)
    kw = dict(algo="linear_sgd", dim=D_IN)
    return (jsub.LinearSubstrate(lcfg=JLearner(**kw), backend=jb),
            tsub.LinearSubstrate(lcfg=TLearner(**kw), backend=backend),
            convert.linear_state)


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("family", ["sv", "rff", "linear"])
def test_state_carried_across_gives_the_same_next_round(family, backend,
                                                        backend_parity):
    jsb, tsb, to_port = _pair(family, backend)
    X, Y = susy_stream(K + 1, M, d=D_IN, seed=11)
    jstate = jsb.init(M)
    for t in range(K):
        jstate, _, _ = jsb.round_stacked(jstate, (jnp.asarray(X[t]),
                                                  jnp.asarray(Y[t])))
        if t == K // 2:          # one sync on the way
            fsync, _ = jsb.average_stacked(jsb.models_of(jstate))
            jstate = jsb.with_models(
                jstate, jsb.adopt(jsb.models_of(jstate), fsync))
    tstate = to_port(jstate, device="cpu")
    for got, want in zip(jax.tree.leaves(convert.to_numpy(tstate)),
                         jax.tree.leaves(jstate)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)

    x, y = X[K], Y[K]
    jnext, jloss, jyhat = jsb.round_stacked(jstate, (jnp.asarray(x),
                                                     jnp.asarray(y)))
    tnext, tloss, tyhat = tsb.on(torch.device("cpu")).round_stacked(
        tstate, (torch.from_numpy(x), torch.from_numpy(y)))
    backend_parity(tloss.numpy(), jloss, "loss")
    backend_parity(tyhat.numpy(), jyhat, "yhat")
    for got, want in zip(jax.tree.leaves(convert.to_numpy(tnext)),
                         jax.tree.leaves(jnext)):
        if np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            backend_parity(got, want, "state")

    # the reference's synchronized model, carried across, is the same
    # distance away from every learner
    jref, _ = jsb.average_stacked(jsb.models_of(jnext))
    if family == "sv":
        tref = convert.sv_model(jref, device="cpu")
    else:
        tref = to_port(jref, device="cpu")
    backend_parity(
        tsb.dist_to_ref(tsb.models_of(tnext), tref).numpy(),
        jsb.dist_to_ref(jsb.models_of(jnext), jref), "dist_to_ref")


def test_rff_spec_carries_the_reference_draw():
    js = JRFFSpec(dim=4, num_features=16, gamma=0.7, seed=5)
    W, b = jrff.rff_params(js)
    ts = convert.rff_spec(js, W, b)
    from repro_torch.core import rff as trff
    tW, tb = trff.rff_params(ts)
    np.testing.assert_array_equal(tW.numpy(), np.asarray(W))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(b))
    assert (ts.dim, ts.num_features, ts.gamma, ts.seed) == (4, 16, 0.7, 5)
    X = np.random.default_rng(0).normal(size=(7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        trff.featurize(ts, tW, tb, torch.from_numpy(X)).numpy(),
        np.asarray(jrff.featurize(js, W, b, jnp.asarray(X))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(dtype):
    """The reference's LM tree carried across and read back is the same
    numbers, in the same type, one dict per layer."""
    from repro.configs import get as jget
    from repro.models import build as jbuild

    from repro_torch.configs import get as tget
    from repro_torch.models import count_params

    jc = jget("qwen2_5_3b").smoke().with_(dtype=dtype)
    tc = tget("qwen2_5_3b").smoke().with_(dtype=dtype)
    jp = jbuild(jc).init(jax.random.PRNGKey(3))
    tp = convert.lm_params(jp, tc, device="cpu")
    want_type = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert len(tp["layers"]) == tc.n_layers and "lm_head" not in tp
    assert count_params(tp) == sum(int(x.size) for x in jax.tree.leaves(jp))
    back = convert.to_numpy(tp)
    stacked = jp["stages"][0]["b0"]
    for i, layer in enumerate(tp["layers"]):
        for got, want, t in zip(
                jax.tree.leaves(back["layers"][i]),
                jax.tree.leaves(jax.tree.map(lambda a: a[i], stacked)),
                jax.tree.leaves(layer)):
            assert t.dtype == want_type
            np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    for key in ("embed", "final_norm"):
        for got, want in zip(jax.tree.leaves(back[key]),
                             jax.tree.leaves(jp[key])):
            np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_lm_params_and_caches_of_the_ssm_carry_across():
    """A bf16 ``mamba2_130m`` smoke tree keeps its float32 ``A_log``,
    ``D`` and ``dt_bias``; the reference's stacked ``SSMState`` and
    ``KVCache`` caches come across one per layer, bitwise."""
    from repro.configs import get as jget
    from repro.models import build as jbuild

    from repro_torch.configs import get as tget
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMState

    jc = jget("mamba2_130m").smoke().with_(dtype="bfloat16")
    tc = tget("mamba2_130m").smoke().with_(dtype="bfloat16")
    api = jbuild(jc)
    jp = api.init(jax.random.PRNGKey(3))
    tp = convert.lm_params(jp, tc, device="cpu")
    ssm = tp["layers"][1]["ssm"]
    assert ssm["in_proj"]["w"].dtype == torch.bfloat16
    assert {ssm[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
    np.testing.assert_array_equal(
        ssm["A_log"].numpy(), np.asarray(jp["stages"][0]["b0"]["ssm"]["A_log"][1]))
    tok = jnp.asarray(np.random.default_rng(0).integers(0, jc.vocab, (2, 7)),
                      jnp.int32)
    _, jcache = api.prefill(jp, {"tokens": tok}, api.init_caches(2, 8))
    got = convert.lm_caches(jcache, tc, device="cpu")
    assert len(got) == tc.n_layers and all(type(c) is SSMState for c in got)
    for i, c in enumerate(got):
        want = jax.tree.map(lambda a: a[i], jcache[0]["b0"])
        assert c.h.dtype == torch.float32
        assert c.conv_buf.dtype == torch.bfloat16
        np.testing.assert_array_equal(c.h.numpy(), np.asarray(want.h))
        np.testing.assert_array_equal(c.conv_buf.float().numpy(),
                                      np.asarray(want.conv_buf, np.float32))
    jc = jget("qwen2_5_3b").smoke()
    kv = convert.lm_caches(jbuild(jc).init_caches(2, 8),
                           tget("qwen2_5_3b").smoke(), device="cpu")
    assert type(kv[0]) is KVCache and kv[0].slot_pos.dtype == torch.int32
    assert kv[0].k.shape == (2, 8, jc.n_kv_heads, jc.hd)
