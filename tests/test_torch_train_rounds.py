"""Six rounds of the port's LM protocol trainer against the JAX
package's, on the CPU.

``qwen2_5_3b``'s smoke variant (fp32, 2 layers, d 256, vocab 512), m =
2 learners, each with its own batch (B 2, S 16) a round.  Both packages
start from one state: the reference's ``init_train_state`` with every
bias and norm scale given seeded noise, carried across by
``convert.train_state``.  Under ``sgd`` (momentum 0 and 0.9, clip 1.0)
and ``adamw`` (clip 1.0), for every protocol kind (the dynamic one also
with ``per_group``), each round's ``syncs``, ``bytes_sent`` and
``step`` are equal and the loss, the divergence, the parameters, the
optimizer state and the reference agree within the suite's parity pair
(tests/conftest.py).  Each dynamic threshold lies between the distances
the rounds reach, so a run has sync rounds and quiet rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.launch import train as jtrain
from repro.models import build as jbuild
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.launch import train as ttrain
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.tree import leaves

ARCH = "qwen2_5_3b"
M = 2
ROUNDS = 6

# (optimizer, dynamic delta, per-group delta): after one clipped sgd
# step a learner is lr^2 = 2.5e-3 from the reference; with momentum 0.9
# the distances grow to 0.012, 0.030 in two and three rounds; adamw
# moves about 1.3 a round.  Per group the embedding table leads: its
# distance over its share of the parameters is 0.021, 0.040 a round
# (sgd), 0.021, 0.094 (momentum), 1.31, 3.2 (adamw)
OPTIMIZERS = [
    (dict(kind="sgd", lr=0.05, grad_clip=1.0), 0.0035, 0.03),
    (dict(kind="sgd", lr=0.05, momentum=0.9, grad_clip=1.0), 0.02, 0.05),
    (dict(kind="adamw", lr=1e-3, grad_clip=1.0), 2.0, 2.0),
]
PROTOCOLS = [dict(kind="none"), dict(kind="continuous"),
             dict(kind="periodic", period=4), dict(kind="dynamic"),
             dict(kind="dynamic", per_group=True)]


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (_noisy(v, k, rng) if k in ("b", "scale")
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _noisy(leaf, key, rng):
    a = np.asarray(leaf, np.float32)
    noise = rng.normal(scale=0.2 if key == "scale" else 0.1, size=a.shape)
    return jnp.asarray(a + noise.astype(np.float32), leaf.dtype)


def _reference_state(cfg, opt_cfg):
    """The reference's ``init_train_state`` from perturbed parameters."""
    p0 = _perturb(jbuild(cfg).init(jax.random.PRNGKey(0)),
                  np.random.default_rng(1))

    def stack(x):
        return jnp.broadcast_to(x[None], (M,) + x.shape).copy()

    return jtrain.TrainState(
        params=jax.tree.map(stack, p0),
        opt=jax.tree.map(stack, jmake(opt_cfg).init(p0)),
        pstate=jproto.init_state(p0, M),
        step=jnp.zeros((), jnp.int32))


def _close(got, want, label):
    gl = [np.asarray(x, np.float32) for x in jax.tree.leaves(
        convert.to_numpy(got))]
    wl = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), label
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("pkw", PROTOCOLS,
                         ids=lambda p: "-".join(map(str, p.values())))
@pytest.mark.parametrize("okw,delta,group_delta", OPTIMIZERS,
                         ids=["sgd", "sgd_momentum", "adamw"])
def test_train_rounds_match_reference(okw, delta, group_delta, pkw):
    jc, tc = jget(ARCH).smoke(), tget(ARCH).smoke()
    pkw = dict(pkw, delta=group_delta if pkw.get("per_group") else delta)
    jstep = jax.jit(jtrain.make_train_step(jc, jproto.ProtocolConfig(**pkw),
                                           JOpt(**okw)))
    tstep = ttrain.make_train_step(tc, tproto.ProtocolConfig(**pkw),
                                   TOpt(**okw))
    jstate = _reference_state(jc, JOpt(**okw))
    tstate = convert.train_state(jstate, tc, "cpu")
    rng = np.random.default_rng(2)
    syncs = []
    for t in range(ROUNDS):
        toks = rng.integers(0, jc.vocab, (M, 2, 17))
        jbatch = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                  "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
        tbatch = {"tokens": torch.as_tensor(toks[..., :-1]),
                  "labels": torch.as_tensor(toks[..., 1:])}
        jstate, jloss = jstep(jstate, jbatch)
        tstate, tloss = tstep(tstate, tbatch)
        label = f"round {t + 1}"
        tp, jp = tstate.pstate, jstate.pstate
        assert int(tstate.step) == int(jstate.step) == t + 1, label
        assert int(tp.step) == int(jp.step) == t + 1, label
        assert int(tp.syncs) == int(jp.syncs), label
        assert np.asarray(tp.bytes_sent).tobytes() == \
            np.asarray(jp.bytes_sent).tobytes(), label
        _close(tloss, jloss, label + " loss")
        _close(tp.last_divergence, jp.last_divergence, label + " divergence")
        # the reference's layout, leaf by leaf (layers unstacked)
        want = convert.train_state(jstate, tc, "cpu")
        for name in ("params", "opt"):
            _close(getattr(tstate, name), convert.to_numpy(getattr(want, name)),
                   f"{label} {name}")
        _close(tp.reference, convert.to_numpy(want.pstate.reference),
               label + " reference")
        syncs.append(int(tp.syncs))
    assert leaves(tstate.params)[0].shape[0] == M
    if pkw["kind"] == "dynamic":
        assert 0 < syncs[-1] < ROUNDS, syncs
