"""The port's Mamba-2 SSM family against the JAX package's, on the CPU.

Block level (``models/ssm.py`` and the conv1d pair of ``layers.py``) on
the reference's own parameters, every bias, norm scale, ``D`` and
``dt_bias`` first given seeded noise (at init they are zeros and ones,
and a dropped one would pass):

- ``_ssd_chunked`` against the naive recurrence of tests/test_ssm.py
  and against JAX's, at that file's (S, chunk) cases, with and without
  an initial state;
- ``ssm_forward`` at S equal to, a multiple of and not a multiple of
  the chunk (the padding path), and with 2 groups over 16 heads, where
  ``jnp.repeat`` and ``Tensor.repeat`` differ;
- a chunked prefill carrying its ``SSMState``, then ``ssm_decode``;
- gradients at chunk 64 with ``dt_bias`` at +5, where the decay's
  exponent passes float32's overflow above the diagonal;
- ``causal_conv1d`` and ``conv1d_step`` in bf16, bitwise;
- ``A_log``, ``D`` and ``dt_bias`` at init, bitwise.

Model level, ``mamba2_130m``'s smoke variant (2 layers, d 256, 16 heads
of 32, state 16, chunk 16, vocab 512) with the reference's parameters
carried across by ``convert.lm_params``: ``forward_lm``, ``lm_loss``,
prefill and teacher-forced decode (float32, and bf16 within
``BF16_TOL``), a decode from JAX's own caches (``convert.lm_caches``),
``LMServingEngine``'s tokens, 6 trainer rounds under each protocol kind
against JAX's ``make_train_step`` (``syncs``, ``bytes_sent`` and
``step`` equal), and a mixed-dtype ``TrainState`` through the
checkpoint, bitwise.  Floats are held to the suite's parity pair
(tests/conftest.py).
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
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake
from repro.serving.lm import LMServingEngine as JEngine
from repro.serving.lm import Request as JRequest

from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.serving.lm import LMServingEngine as TEngine
from repro_torch.serving.lm import Request as TRequest
from repro_torch.tree import leaves

ARCH = "mamba2_130m"
BF16_TOL = 3e-2          # tests/test_torch_lm.py's, the JAX package's bf16
M = 2
ROUNDS = 6
NOISY = {"b": 0.1, "scale": 0.2, "D": 0.2, "dt_bias": 0.3}


def _cfgs(**kw):
    return jget(ARCH).smoke().with_(**kw), tget(ARCH).smoke().with_(**kw)


def _perturb(tree, rng):
    """Seeded noise on every bias, norm scale, ``D`` and ``dt_bias``."""
    if isinstance(tree, dict):
        return {k: (_noisy(v, k, rng) if k in NOISY else _perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _noisy(leaf, key, rng):
    a = np.asarray(leaf, np.float32)
    noise = rng.normal(scale=NOISY[key], size=a.shape).astype(np.float32)
    return jnp.asarray(a + noise, leaf.dtype)


def _torch_tree(tree):
    """A block's parameters carried across, each leaf in its own type."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    t = torch.as_tensor(np.array(tree, np.float32))
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _close(got, want, label, tol=None):
    """Within the parity pair; with ``tol`` (bf16) within ``tol`` of
    |want| plus ``tol`` of the largest |want|: the two packages round a
    chain of bf16 operations at different points (XLA fuses, PyTorch
    rounds each operation), and one rounding near the largest value is
    2^-8 of it, however small the element."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.all(np.isfinite(got)), label
    if tol is None:
        rtol, atol = PARITY_RTOL, PARITY_ATOL
    else:
        rtol, atol = tol, tol * float(np.max(np.abs(want), initial=1.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def _bits(x):
    if torch.is_tensor(x):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# The chunked SSD
# ---------------------------------------------------------------------------


def _naive_ssd(x, Bm, Cm, dt, A_log, h0):
    """tests/test_ssm.py's step-by-step oracle:
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t (x) x_t ;  y_t = C_t . h_t."""
    Bsz, S, H, P = x.shape
    a = -np.exp(np.asarray(A_log))
    h = np.asarray(h0).copy()
    ys = np.zeros((Bsz, S, H, P), np.float32)
    for t in range(S):
        decay = np.exp(dt[:, t] * a)
        h = decay[:, :, None, None] * h + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Cm[:, t], h)
    return ys, h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (24, 8), (16, 16)])
def test_ssd_chunked_matches_naive_and_reference(S, chunk, with_h0):
    kw = dict(arch_type="ssm", ssm_state=8, ssm_head_dim=4, ssm_chunk=chunk,
              d_model=8, vocab=32, attn_kind="none", pos_kind="none")
    jc, tc = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(S + chunk)
    Bsz, H, P, N = 2, tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state
    x = rng.normal(size=(Bsz, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(Bsz, S, 1, N)).astype(np.float32)
    Cm = rng.normal(size=(Bsz, S, 1, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(Bsz, S, H)).astype(np.float32)
    A_log = np.log(rng.uniform(0.5, 4.0, size=(H,))).astype(np.float32)
    h0 = (rng.normal(size=(Bsz, H, P, N)) if with_h0
          else np.zeros((Bsz, H, P, N))).astype(np.float32)
    y, hT = tssm._ssd_chunked(tc, *map(_t, (x, Bm, Cm, dt, A_log, h0)))
    y_ref, h_ref = _naive_ssd(x, np.repeat(Bm, H, 2), np.repeat(Cm, H, 2),
                              dt, A_log, h0)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hT.numpy(), h_ref, rtol=1e-4, atol=1e-4)
    jy, jh = jssm._ssd_chunked(jc, *map(jnp.asarray,
                                        (x, Bm, Cm, dt, A_log, h0)))
    _close(y, jy, "y")
    _close(hT, jh, "h")


_BLOCK = {}


def _block(groups=1, dtype="float32"):
    """(reference cfg, port cfg, reference params, port params) of one
    perturbed Mamba-2 block at the smoke widths (16 heads)."""
    key = (groups, dtype)
    if key not in _BLOCK:
        jc, tc = _cfgs(ssm_groups=groups, dtype=dtype)
        jp = _perturb(jssm.ssm_init(jax.random.PRNGKey(groups), jc,
                                    jnp.dtype(dtype)),
                      np.random.default_rng(groups))
        _BLOCK[key] = (jc, tc, jp, _torch_tree(jp))
    return _BLOCK[key]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S", [16, 48, 21, 5])
def test_ssm_forward_matches_reference(S, groups):
    """S = chunk, a multiple of it, neither (padded to 32), and below it
    (a chunk of S); with 2 groups head h reads group h // 8."""
    jc, tc, jp, tp = _block(groups)
    assert tc.ssm_chunk == 16 and tc.ssm_heads == 16
    x = np.random.default_rng(S).normal(size=(2, S, tc.d_model))
    x = x.astype(np.float32)
    jy, jst = jax.jit(lambda p, x: jssm.ssm_forward(jc, p, x))(
        jp, jnp.asarray(x))
    ty, tst = tssm.ssm_forward(tc, tp, _t(x))
    _close(ty, jy, f"y S={S}")
    _close(tst.h, jst.h, "h")
    _close(tst.conv_buf, jst.conv_buf, "conv_buf")


def test_groups_are_consecutive_heads():
    """Two groups: ``Tensor.repeat`` (groups interleaved over the heads)
    gives another output; the port's is the reference's."""
    jc, tc, jp, tp = _block(2)
    x = np.random.default_rng(7).normal(size=(1, 16, tc.d_model))
    x = x.astype(np.float32)
    want = np.asarray(jssm.ssm_forward(jc, jp, jnp.asarray(x))[0])
    orig = torch.repeat_interleave

    def tiled(t, rep, dim):
        return t.repeat(*[rep if i == dim else 1 for i in range(t.dim())])

    torch.repeat_interleave = tiled
    try:
        wrong = tssm.ssm_forward(tc, tp, _t(x))[0].numpy()
    finally:
        torch.repeat_interleave = orig
    assert np.max(np.abs(wrong - want)) > 10 * PARITY_ATOL
    _close(tssm.ssm_forward(tc, tp, _t(x))[0], want, "groups")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_then_decode_matches_reference(dtype):
    """Prefill 20 tokens, then 13 more from the carried state (the
    padding path twice), then 4 decode steps: outputs and states against
    JAX's on the same calls, and the last decode against one full
    forward of the 37 tokens (the reference's own 1e-3)."""
    jc, tc, jp, tp = _block(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    x = np.random.default_rng(11).normal(size=(2, 37, tc.d_model))
    x = x.astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = _t(x).to(torch.bfloat16 if dtype == "bfloat16"
                  else torch.float32)
    jst = tst = None
    for a, b in ((0, 20), (20, 33)):
        jy, jst = jssm.ssm_forward(jc, jp, jx[:, a:b], jst)
        ty, tst = tssm.ssm_forward(tc, tp, tx[:, a:b], tst)
        _close(ty, jy, f"prefill {a}:{b}", tol)
        _close(tst.h, jst.h, "h", tol)
        _close(tst.conv_buf, jst.conv_buf, "conv_buf", tol)
    for t in range(33, 37):
        jy, jst = jssm.ssm_decode(jc, jp, jx[:, t:t + 1], jst)
        ty, tst = tssm.ssm_decode(tc, tp, tx[:, t:t + 1], tst)
        _close(ty, jy, f"decode {t}", tol)
        _close(tst.h, jst.h, f"decode h {t}", tol)
    if dtype == "float32":
        full = tssm.ssm_forward(tc, tp, tx)[0][:, -1:]
        np.testing.assert_allclose(ty.numpy(), full.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_gradients_are_finite_where_the_exponent_overflows():
    """Chunk 64, dt_bias +5: softplus(dt) is about 5 and A up to 16, so
    above the diagonal cum_t - cum_s reaches thousands and exp() is inf
    there; masking the exponent keeps every gradient finite, and equal
    to ``jax.grad``'s."""
    jc, tc = _cfgs(ssm_chunk=64)
    jp = jssm.ssm_init(jax.random.PRNGKey(5), jc, jnp.float32)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 5.0))
    tp = _torch_tree(jp)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 64, tc.d_model)).astype(np.float32)
    r = rng.normal(size=(2, 64, tc.d_model)).astype(np.float32)
    # the inputs reach the overflow: the largest masked exponent
    proj = np.asarray(jlayers.dense(jp["in_proj"], jnp.asarray(x)))
    dt = np.asarray(jax.nn.softplus(proj[..., -tc.ssm_heads:] + 5.0))
    cum = np.cumsum(dt * -np.exp(np.asarray(jp["A_log"])), axis=1)
    assert np.max(cum[:, :1] - cum[:, -1:]) > 88.8    # exp(88.8) = inf

    def jloss(p, x):
        return jnp.sum(jssm.ssm_forward(jc, p, x)[0] * r)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    flat = [v.requires_grad_(True) for v in leaves(tp)]
    tx = _t(x).requires_grad_(True)
    loss = torch.sum(tssm.ssm_forward(tc, tp, tx)[0] * _t(r))
    grads = torch.autograd.grad(loss, flat + [tx])
    for g, w, name in zip(grads, jax.tree.leaves(jg) + [jgx],
                          [str(p) for p in jax.tree_util.tree_flatten_with_path(
                              jg)[0]] + ["x"]):
        assert torch.isfinite(g).all(), name
        scale = float(np.max(np.abs(np.asarray(w)))) or 1.0
        _close(g / scale, np.asarray(w) / scale, f"grad {name}")


@pytest.mark.parametrize("left", [False, True])
def test_conv1d_is_bitwise_in_bf16(left):
    rng = np.random.default_rng(13)
    width, C = 4, 96
    p = jlayers.conv1d_init(jax.random.PRNGKey(0), width, C, jnp.bfloat16)
    p = dict(p, b=jnp.asarray(rng.normal(scale=0.3, size=C), jnp.bfloat16))
    tp = _torch_tree(p)
    x = jnp.asarray(rng.normal(size=(2, 37, C)), jnp.bfloat16)
    lc = jnp.asarray(rng.normal(size=(2, width - 1, C)), jnp.bfloat16)
    tx, tlc = _torch_tree({"x": x, "l": lc}).values()
    want = jlayers.causal_conv1d(p, x, lc if left else None)
    got = tlayers.causal_conv1d(tp, tx, tlc if left else None)
    assert got.dtype == torch.bfloat16 and _bits(got) == _bits(want)
    want = jax.jit(jlayers.causal_conv1d)(p, x, lc)
    assert _bits(tlayers.causal_conv1d(tp, tx, tlc)) == _bits(want)
    jbuf, jo = jlayers.conv1d_step(p, lc, x[:, 0])
    tbuf, to = tlayers.conv1d_step(tp, tlc, tx[:, 0])
    assert _bits(to) == _bits(jo) and _bits(tbuf) == _bits(jbuf)


HEADS = tuple(range(1, 41)) + (48, 64, 96, 128, 256, 352)


def test_init_leaves_match_the_reference():
    """``A_log`` bitwise at head counts 1 to 40 and six larger ones (the
    configs have 16 and 24), its log bitwise ``jnp.log``'s on 2e5
    values across float32's range, ``D`` and ``dt_bias`` bitwise; every
    leaf's shape and type as the reference's, at the smoke and the full
    widths."""
    lin = [np.asarray(jnp.linspace(1.0, 16.0, H)) for H in HEADS]
    for H, w in zip(HEADS, lin):
        assert tssm._linspace_1_16(H).tobytes() == w.tobytes(), H
    want = np.asarray(jnp.log(jnp.asarray(np.concatenate(lin))))
    got = np.concatenate([tssm.a_log_init(H) for H in HEADS])
    assert got.tobytes() == want.tobytes()
    # torch.log of the same linspace is off the reference's bits at
    # mamba2_130m's 24 heads: the emulated log is what makes A_log equal
    lin24 = torch.from_numpy(tssm._linspace_1_16(24))
    assert torch.log(lin24).numpy().tobytes() != tssm.a_log_init(24).tobytes()
    v = np.exp(np.random.default_rng(14).uniform(-87, 88, 200_000))
    v = v.astype(np.float32)
    assert tssm._log_f32(v).tobytes() == np.asarray(
        jnp.log(jnp.asarray(v))).tobytes()
    for jc, tc in ((jget(ARCH), tget(ARCH)),
                   (jget(ARCH).smoke(), tget(ARCH).smoke())):
        jp = jax.eval_shape(lambda k: jssm.ssm_init(k, jc, jnp.bfloat16),
                            jax.random.PRNGKey(0))
        tp = tssm.ssm_init(torch.Generator().manual_seed(0), tc,
                           torch.bfloat16)
        jv = {k: jssm.ssm_init(jax.random.PRNGKey(0), jc, jnp.bfloat16)[k]
              for k in ("A_log", "D", "dt_bias")} if tc.d_model <= 256 \
            else {"A_log": jnp.log(jnp.linspace(1.0, 16.0, jc.ssm_heads))}
        for k, w in jv.items():
            assert tp[k].dtype == torch.float32
            assert _bits(tp[k]) == _bits(w), k
        paths = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert len(paths) == len(leaves(tp))
        for (path, j), t in zip(paths, leaves(tp)):
            assert tuple(t.shape) == j.shape, path
            assert str(t.dtype)[6:] == str(j.dtype), path


# ---------------------------------------------------------------------------
# The mamba2_130m smoke model
# ---------------------------------------------------------------------------


_PARAMS = {}


def _params(dtype="float32"):
    if dtype not in _PARAMS:
        jc, tc = _cfgs(dtype=dtype)
        jp = _perturb(jbuild(jc).init(jax.random.PRNGKey(0)),
                      np.random.default_rng(1))
        _PARAMS[dtype] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[dtype]


def _tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def test_params_carry_across_with_their_types():
    jp, tp = _params("bfloat16")
    layer = tp["layers"][0]
    assert layer["ssm"]["in_proj"]["w"].dtype == torch.bfloat16
    assert layer["ssm"]["A_log"].dtype == torch.float32
    assert not torch.all(layer["ssm"]["D"] == 1)
    assert not torch.all(layer["ssm"]["dt_bias"] == 0)
    assert "lm_head" not in tp                    # tied embeddings
    assert sum(x.numel() for x in leaves(tp)) == sum(
        int(x.size) for x in jax.tree.leaves(jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    jp, tp = _params(dtype)
    jc, tc = _cfgs(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(3)
    tok = _tokens(rng, jc.vocab, 2, 21)
    lab = _tokens(rng, jc.vocab, 2, 21)
    japi, tapi = jbuild(jc), tbuild(tc)
    want, jaux = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(tok)})
    ops.reset_launch_counts()
    got, taux = tapi.forward(tp, {"tokens": torch.as_tensor(tok).long()})
    assert not ops.LAUNCH_COUNTS
    _close(got, want, "forward_lm logits", tol)
    assert float(taux) == float(jaux) == 0.0
    batch = {"tokens": tok, "labels": lab}
    jl = jax.jit(japi.loss)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl = tapi.loss(tp, {k: torch.as_tensor(v).long() for k, v in batch.items()})
    _close(tl, jl, "lm_loss", tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode_match_reference(dtype):
    """Prefill (19 tokens: the padding path), then 6 decode steps fed
    the reference's greedy tokens; logits and every layer's state
    against JAX's.  Then a decode from JAX's own caches carried across
    (``convert.lm_caches``)."""
    jp, tp = _params(dtype)
    jc, tc = _cfgs(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S = 2, 19
    tok = _tokens(np.random.default_rng(4), jc.vocab, B, S)
    jlog, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(tok)},
                                         japi.init_caches(B, 4))
    tcache = tapi.init_caches(B, 4, device="cpu")
    assert type(tcache[0]).__name__ == "SSMState"
    tlog, tcache = tapi.prefill(tp, {"tokens": torch.as_tensor(tok).long()},
                                tcache)
    _close(tlog, jlog, "prefill logits", tol)

    def check_states(label):
        want = convert.lm_caches(jcache, tc, "cpu")
        for i, (g, w) in enumerate(zip(tcache, want)):
            _close(g.h, w.h, f"{label} h layer {i}", tol)
            _close(g.conv_buf, w.conv_buf, f"{label} conv layer {i}", tol)

    check_states("prefill")
    decode = jax.jit(japi.decode)
    for step in range(6):
        nxt = np.argmax(np.asarray(jlog, np.float32)[:, -1, :jc.vocab],
                        axis=-1).astype(np.int32)[:, None]
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, torch.as_tensor(nxt).long(),
                                   S + step)
        _close(tlog, jlog, f"decode step {step} logits", tol)
    check_states("decode")
    # a decode from the reference's caches
    nxt = np.asarray([[3], [5]], np.int32)
    want, _ = decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(S + 6))
    got, _ = tapi.decode(tp, convert.lm_caches(jcache, tc, "cpu"),
                         torch.as_tensor(nxt).long(), S + 6)
    _close(got, want, "decode from JAX's caches", tol)


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    spec = [(5, 6), (19, 4), (3, 0), (7, 5), (33, 3)]
    return [cls(uid=i, prompt=_tokens(rng, vocab, n), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)]


#: served tokens whose reference top-2 margin is within the parity pair
#: at its top logit, measured at this seed (request 0's fourth); its
#: token agrees all the same
NEAR_TIES = 1


def test_serving_engine_tokens_match_reference():
    """Batches of 3, left-padded with token 0 (absorbed into the state
    as in the reference), one batch filled with a dummy: every token
    equal to the reference's.  The reference's greedy run replayed at
    the model API counts the near ties among them."""
    jp, tp = _params()
    jc, tc = _cfgs()
    want = JEngine(jc, jp, batch_size=3, max_len=64).run(
        _requests(JRequest, jc.vocab))
    ops.reset_launch_counts()
    got = TEngine(tc, tp, batch_size=3, max_len=64, device="cpu").run(
        _requests(TRequest, tc.vocab))
    assert not ops.LAUNCH_COUNTS
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert sum(len(r.output) for r in got) == 18
    api = jbuild(jc)
    prefill, decode = jax.jit(api.prefill), jax.jit(api.decode)
    ties = 0
    for b0 in (0, 3):
        batch = want[b0:b0 + 3]
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((3, S), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt
        logits, caches = prefill(jp, {"tokens": jnp.asarray(toks)},
                                 api.init_caches(3, 64))
        for step in range(max(len(r.output) for r in batch)):
            lg = np.asarray(logits, np.float32)[:, -1, :jc.vocab]
            top2 = np.sort(lg)[:, -2:]
            nxt = np.zeros((3, 1), np.int32)
            for i, r in enumerate(batch):
                if step < len(r.output):
                    assert r.output[step] == int(np.argmax(lg[i]))
                    nxt[i, 0] = r.output[step]
                    ties += int(top2[i, 1] - top2[i, 0] <= PARITY_ATOL
                                + PARITY_RTOL * abs(top2[i, 1]))
            logits, caches = decode(jp, caches, jnp.asarray(nxt),
                                    jnp.asarray(S + step, jnp.int32))
    assert ties == NEAR_TIES


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


PROTOCOLS = [dict(kind="none"), dict(kind="continuous"),
             dict(kind="periodic", period=4), dict(kind="dynamic")]
# the dynamic delta lies between the distances the rounds reach: after
# one clipped sgd step a learner is lr^2 = 2.5e-3 from the reference
DELTA = 0.0035


def _reference_state(cfg, opt_cfg):
    p0 = _perturb(jbuild(cfg).init(jax.random.PRNGKey(0)),
                  np.random.default_rng(1))

    def stack(x):
        return jnp.broadcast_to(x[None], (M,) + x.shape).copy()

    return jtrain.TrainState(
        params=jax.tree.map(stack, p0),
        opt=jax.tree.map(stack, jmake(opt_cfg).init(p0)),
        pstate=jproto.init_state(p0, M),
        step=jnp.zeros((), jnp.int32))


def _close_trees(got, want, label):
    gl = [np.asarray(x, np.float32) for x in jax.tree.leaves(
        convert.to_numpy(got))]
    wl = [np.asarray(x, np.float32) for x in jax.tree.leaves(
        convert.to_numpy(want))]
    assert len(gl) == len(wl), label
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=label)


@pytest.mark.parametrize("pkw", PROTOCOLS, ids=lambda p: p["kind"])
def test_train_rounds_match_reference(pkw):
    """m = 2, B 2 x S 16 a learner a round, sgd (lr 0.05, clip 1.0)."""
    jc, tc = _cfgs()
    okw = dict(kind="sgd", lr=0.05, grad_clip=1.0)
    pkw = dict(pkw, delta=DELTA)
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
        assert _bits(tp.bytes_sent) == _bits(jp.bytes_sent), label
        _close(tloss, jloss, label + " loss")
        _close(tp.last_divergence, jp.last_divergence, label + " divergence")
        want = convert.train_state(jstate, tc, "cpu")
        _close_trees(tstate.params, want.params, label + " params")
        _close_trees(tp.reference, want.pstate.reference, label + " reference")
        syncs.append(int(tp.syncs))
    if pkw["kind"] == "dynamic":
        assert 0 < syncs[-1] < ROUNDS, syncs
    one = jax.tree.map(lambda x: x[0], jstate.params)
    assert tproto.model_bytes(convert.lm_params(one, tc, "cpu")) == \
        jproto.model_bytes(one)


def test_mixed_dtype_train_state_checkpoint_round_trips(tmp_path):
    _, tc = _cfgs(dtype="bfloat16")
    opt_cfg = TOpt(kind="adamw", lr=1e-3)
    state = ttrain.init_train_state(0, tc, M, opt_cfg, device="cpu")
    step = ttrain.make_train_step(
        tc, tproto.ProtocolConfig(kind="periodic", period=1), opt_cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab, (M, 1, 9)))
    state, loss = step(state, {"tokens": toks[..., :-1],
                               "labels": toks[..., 1:]})
    assert torch.isfinite(loss)
    kinds = {x.dtype for x in leaves(state.params)}
    assert kinds == {torch.bfloat16, torch.float32}, kinds
    path = tckpt.save_step(str(tmp_path), 1, state)
    got = tckpt.restore(path, ttrain.init_train_state(1, tc, M, opt_cfg,
                                                      device="cpu"))
    assert type(got) is ttrain.TrainState
    for g, w in zip(leaves(got), leaves(state)):
        assert g.dtype == w.dtype and _bits(g) == _bits(w.contiguous())
