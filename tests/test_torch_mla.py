"""Multi-head latent attention (MLA) in the port against the JAX package,
on the CPU (``minicpm3_4b``).

- ``mla_init``'s leaves: the reference's keys, shapes and dtypes
  (float32 and bf16).
- At ``minicpm3_4b.smoke()`` (2 layers, d 256, 4 heads, q_lora 64,
  kv_lora 32, nope 32, rope 16, v 32, float32) with one layer's
  parameters: ``mla_forward`` (causal, and windowed); the transformer's
  ``_mla_prefill`` and its cache (``c``, ``k_rope``, ``slot_pos``
  exactly); ``mla_decode``, absorbed and naive, each step against the
  reference's same form, and the cache; a windowed decode (a ring of 8
  slots) run 20 tokens past its ring.
- The reference's contracts (tests/test_attention.py:58 and :80) on the
  port: absorbed equals naive (rtol 1e-4, atol 1e-5) and the forward's
  last row equals the decode chain's.
- The windowed prefill past its ring raises in both packages: the
  reference's ``lax.dynamic_update_slice`` refuses it (a limit of the
  reference, ROADMAP.md), and the port raises rather than invent a ring
  fill for MLA.
- The smoke model: ``forward_lm`` and ``lm_loss`` (bf16 too, within
  ``BF16_TOL`` of |want| plus ``BF16_TOL`` of the largest |want|), a
  prefill and 8 decode steps with every layer's cache, a decode from
  JAX's caches (``convert.lm_caches`` builds ``MLACache``s),
  tests/test_decode.py's contract, ``LMServingEngine``'s tokens equal to
  JAX's, 6 trainer rounds a protocol kind, ``launch.specs``.

Parameters are the reference's tree filled with numpy draws from a seed
(norm scales away from one), carried across by ``convert.lm_params``.
Floats are held to the suite's parity pair unless said otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import transformer as jtransformer
from repro.models.config import param_count
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake
from repro.serving.lm import LMServingEngine as JEngine
from repro.serving.lm import Request as JRequest

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.serving.lm import LMServingEngine as TEngine
from repro_torch.serving.lm import Request as TRequest
from repro_torch.tree import leaves

# the helpers, the draw and the one-thread autouse fixture are shared
from test_torch_vlm import (_close, _draw, _f32, _long, _np,  # noqa: F401
                            _one_thread, _tokens, check_specs)

ARCH = "minicpm3_4b"
BF16_TOL = 3e-2          # tests/test_torch_ssm.py's bf16 model tolerance
DECODE_TOL = 2e-2        # tests/test_decode.py:37
M = 2
ROUNDS = 6
WINDOW = 8


def _cfgs(**kw):
    return jget(ARCH).smoke().with_(**kw), tget(ARCH).smoke().with_(**kw)


_PARAMS = {}


def _params(dtype="float32"):
    if dtype not in _PARAMS:
        jc, tc = _cfgs(dtype=dtype)
        rng = np.random.default_rng(1)
        shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
        jp = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _draw(path, leaf, rng), shapes)
        _PARAMS[dtype] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[dtype]


_JIT = {}


def _jit(jc, name):
    if (jc, name) not in _JIT:
        _JIT[jc, name] = jax.jit(getattr(jbuild(jc), name))
    return _JIT[jc, name]


def _attn_params():
    jp, tp = _params()
    return (jax.tree.map(lambda x: x[0], jp["stages"][0]["b0"]["attn"]),
            tp["layers"][0]["attn"])


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_init_leaves_match_reference(dtype):
    jc, tc = _cfgs(dtype=dtype)
    want = jattn.mla_init(jax.random.PRNGKey(0), jc, jnp.dtype(dtype))
    got = tattn.mla_init(torch.Generator().manual_seed(0), tc,
                         getattr(torch, dtype))
    assert list(got) == list(want)
    for key in want:
        for f in want[key]:
            w, g = want[key][f], got[key][f]
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == \
                str(w.dtype), (key, f)
    assert torch.equal(got["q_norm"]["scale"],
                       torch.ones(jc.mla_q_lora, dtype=got["wo"]["w"].dtype))
    assert tattn.attn_init(torch.Generator(), tc, torch.float32).keys() == \
        got.keys()


@pytest.mark.parametrize("window", [0, 5])
def test_mla_forward_matches_reference(window):
    jc, tc = _cfgs()
    jpa, tpa = _attn_params()
    x = np.random.default_rng(2).normal(size=(2, 13, jc.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jattn.mla_forward(jc, p, x, window=window))(
        jpa, jnp.asarray(x))
    got = tattn.mla_forward(tc, tpa, _f32(x), window=window)
    _close(got, want, "mla_forward")
    pos = np.broadcast_to(np.arange(3, 16), (2, 13))
    want = jax.jit(lambda p, x, pos: jattn.mla_forward(
        jc, p, x, pos, causal=False))(jpa, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.mla_forward(tc, tpa, _f32(x), _long(pos), causal=False)
    _close(got, want, "mla_forward at positions 3.., not causal")


def test_mla_prefill_cache_matches_reference():
    jc, tc = _cfgs()
    jpa, tpa = _attn_params()
    x = np.random.default_rng(3).normal(size=(2, 11, jc.d_model)).astype(
        np.float32)
    jcache = jattn.init_mla_cache(jc, 2, 16, jnp.float32)
    want, jcache = jax.jit(lambda p, h, c: jtransformer._mla_prefill(
        jc, p, h, None, c))(jpa, jnp.asarray(x), jcache)
    tcache = tattn.init_mla_cache(tc, 2, 16, torch.float32)
    got, tcache = ttransformer._mla_prefill(tc, tpa, _f32(x), None, tcache)
    _close(got, want, "prefill output")
    _close(tcache.c, jcache.c, "cache c")
    _close(tcache.k_rope, jcache.k_rope, "cache k_rope")
    assert tcache.slot_pos.tolist() == np.asarray(jcache.slot_pos).tolist()
    assert tcache.slot_pos.tolist() == list(range(11)) + [-1] * 5


@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_mla_decode_matches_reference(absorbed):
    """8 steps from an empty cache of 12 slots, each output against the
    reference's same form; then the cache."""
    jc, tc = _cfgs()
    jpa, tpa = _attn_params()
    rng = np.random.default_rng(4)
    jcache = jattn.init_mla_cache(jc, 2, 12, jnp.float32)
    tcache = tattn.init_mla_cache(tc, 2, 12, torch.float32)
    decode = jax.jit(lambda p, x, t, c: jattn.mla_decode(
        jc, p, x, t, c, absorbed=absorbed))
    for t in range(8):
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        want, jcache = decode(jpa, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                              jcache)
        got, tcache = tattn.mla_decode(tc, tpa, _f32(x), t, tcache,
                                       absorbed=absorbed)
        _close(got, want, f"step {t}")
    _close(tcache.c, jcache.c, "cache c")
    _close(tcache.k_rope, jcache.k_rope, "cache k_rope")
    assert tcache.slot_pos.tolist() == np.asarray(jcache.slot_pos).tolist()


def test_windowed_mla_decode_past_the_ring():
    """A ring of WINDOW slots, 28 tokens: slot pos % 8, masked by
    ``slot_pos``, each step against the reference's."""
    jc, tc = _cfgs(window=WINDOW)
    jpa, tpa = _attn_params()
    rng = np.random.default_rng(5)
    jcache = jattn.init_mla_cache(jc, 1, WINDOW, jnp.float32)
    tcache = tattn.init_mla_cache(tc, 1, WINDOW, torch.float32)
    decode = jax.jit(lambda p, x, t, c: jattn.mla_decode(
        jc, p, x, t, c, window=WINDOW))
    for t in range(28):
        x = rng.normal(size=(1, 1, jc.d_model)).astype(np.float32)
        want, jcache = decode(jpa, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                              jcache)
        got, tcache = tattn.mla_decode(tc, tpa, _f32(x), t, tcache,
                                       window=WINDOW)
        _close(got, want, f"step {t}")
    assert tcache.slot_pos.tolist() == np.asarray(jcache.slot_pos).tolist()
    assert sorted(tcache.slot_pos.tolist()) == list(range(20, 28))
    _close(tcache.c, jcache.c, "ring c")


def _contract_cfg():
    """tests/test_attention.py:59's configuration."""
    return tget(ARCH).with_(d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                            vocab=32, mla_q_lora=16, mla_kv_lora=8,
                            mla_rope_dim=4, mla_nope_dim=8, mla_v_dim=8,
                            dtype="float32")


def test_mla_absorbed_equals_naive_decode():
    """tests/test_attention.py:58 on the port."""
    cfg = _contract_cfg()
    p = tattn.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    rng = np.random.default_rng(0)
    x_t = _f32(rng.normal(size=(2, 1, 32)))
    cache = tattn.init_mla_cache(cfg, 2, 8, torch.float32)
    for t in range(3):
        _, cache = tattn.mla_decode(cfg, p, _f32(rng.normal(size=(2, 1, 32))),
                                    t, cache)
    saved = cache._replace(c=cache.c.clone(), k_rope=cache.k_rope.clone(),
                           slot_pos=cache.slot_pos.clone())
    y_abs, _ = tattn.mla_decode(cfg, p, x_t, 3, cache, absorbed=True)
    y_naive, _ = tattn.mla_decode(cfg, p, x_t, 3, saved, absorbed=False)
    np.testing.assert_allclose(_np(y_abs), _np(y_naive), rtol=1e-4,
                               atol=1e-5)


def test_mla_forward_matches_decode_chain():
    """tests/test_attention.py:80 on the port."""
    cfg = _contract_cfg()
    p = tattn.mla_init(torch.Generator().manual_seed(1), cfg, torch.float32)
    x = _f32(np.random.default_rng(2).normal(size=(1, 6, 32)))
    y_full = tattn.mla_forward(cfg, p, x)
    cache = tattn.init_mla_cache(cfg, 1, 8, torch.float32)
    for t in range(6):
        y_t, cache = tattn.mla_decode(cfg, p, x[:, t:t + 1], t, cache)
    np.testing.assert_allclose(_np(y_t[:, 0]), _np(y_full[:, -1]), rtol=1e-4,
                               atol=1e-5)


def test_windowed_prefill_past_the_ring_raises_in_both():
    jp, tp = _params()
    jc, tc = _cfgs(window=WINDOW)
    tok = _tokens(np.random.default_rng(6), jc.vocab, 1, 12)
    japi, tapi = jbuild(jc), tbuild(tc)
    prefill, decode = _jit(jc, "prefill"), _jit(jc, "decode")
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        prefill(jp, {"tokens": jnp.asarray(tok)}, japi.init_caches(1, 64))
    with pytest.raises(ValueError, match="MLA prefill of 12 tokens"):
        tapi.prefill(tp, {"tokens": _long(tok)},
                     tapi.init_caches(1, 64, device="cpu"))
    # within the ring both prefill, and decode on past it
    want, jcache = prefill(jp, {"tokens": jnp.asarray(tok[:, :6])},
                           japi.init_caches(1, 64))
    got, tcache = tapi.prefill(tp, {"tokens": _long(tok[:, :6])},
                               tapi.init_caches(1, 64, device="cpu"))
    _close(got, want, "windowed prefill within the ring")
    for t in range(6, 14):
        want, jcache = decode(jp, jcache, jnp.asarray(tok[:, :1]),
                              jnp.asarray(t, jnp.int32))
        got, tcache = tapi.decode(tp, tcache, _long(tok[:, :1]), t)
        _close(got, want, f"windowed decode at {t}")


# ---------------------------------------------------------------------------
# The smoke model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    jp, tp = _params(dtype)
    jc, tc = _cfgs(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(7)
    tok, lab = _tokens(rng, jc.vocab, 2, 19), _tokens(rng, jc.vocab, 2, 19)
    want, _ = _jit(jc, "forward")(jp, {"tokens": jnp.asarray(tok)})
    ops.reset_launch_counts()
    got, _ = tbuild(tc).forward(tp, {"tokens": _long(tok)})
    assert not ops.LAUNCH_COUNTS
    _close(got, want, "forward_lm logits", tol)
    jl = _jit(jc, "loss")(jp, {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(lab)})
    tl = tbuild(tc).loss(tp, {"tokens": _long(tok), "labels": _long(lab)})
    _close(tl, jl, "lm_loss", tol)


def test_prefill_and_decode_match_reference():
    """Prefill of 17 tokens into caches of 32, then 8 decode steps fed
    the reference's greedy tokens: logits and every layer's cache; then
    a decode from JAX's caches."""
    jp, tp = _params()
    jc, tc = _cfgs()
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, L = 2, 17, 32
    tok = _tokens(np.random.default_rng(8), jc.vocab, B, S)
    jlog, jcache = _jit(jc, "prefill")(jp, {"tokens": jnp.asarray(tok)},
                                       japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, {"tokens": _long(tok)},
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, "prefill logits")
    decode = _jit(jc, "decode")
    for step in range(8):
        nxt = np.argmax(np.asarray(jlog)[:, -1, :jc.vocab], -1)[:, None]
        nxt = nxt.astype(np.int32)
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _long(nxt), S + step)
        _close(tlog, jlog, f"decode step {step}")
    want = convert.lm_caches(jcache, tc, "cpu")
    for got, w in zip(tcache, want):
        assert isinstance(got, tattn.MLACache) and isinstance(w,
                                                              tattn.MLACache)
        _close(got.c, w.c, "cache c")
        _close(got.k_rope, w.k_rope, "cache k_rope")
        assert torch.equal(got.slot_pos, w.slot_pos)
    nxt = np.asarray([[7], [3]], np.int32)
    want, _ = decode(jp, jcache, jnp.asarray(nxt),
                     jnp.asarray(S + 8, jnp.int32))
    got, _ = tapi.decode(tp, convert.lm_caches(jcache, tc, "cpu"),
                         _long(nxt), S + 8)
    _close(got, want, "decode from JAX's caches")


def test_prefill_and_decode_match_full_forward():
    """tests/test_decode.py:12-45 on the port."""
    _, tp = _params()
    _, tc = _cfgs()
    api = tbuild(tc)
    B, S = 2, 16
    tokens = _long(np.random.default_rng(0).integers(0, tc.vocab, (B, S + 1)))
    full, _ = api.forward(tp, {"tokens": tokens[:, :S]})
    caches = api.init_caches(B, S + 8, device="cpu")
    pre, caches = api.prefill(tp, {"tokens": tokens[:, :S]}, caches)
    a, b = _np(full[:, -1, :tc.vocab]), _np(pre[:, -1, :tc.vocab])
    assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < DECODE_TOL
    dec, _ = api.decode(tp, caches, tokens[:, S:S + 1], S)
    full2, _ = api.forward(tp, {"tokens": tokens})
    a, b = _np(full2[:, -1, :tc.vocab]), _np(dec[:, -1, :tc.vocab])
    assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < DECODE_TOL


def _requests(cls, vocab):
    rng = np.random.default_rng(9)
    spec = [(21, 5), (3, 4), (30, 6)]
    return [cls(uid=i, prompt=_tokens(rng, vocab, n), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)]


def test_serving_engine_tokens_match_reference():
    jp, tp = _params()
    jc, tc = _cfgs()
    want = JEngine(jc, jp, batch_size=4, max_len=48).run(
        _requests(JRequest, jc.vocab))
    ops.reset_launch_counts()
    got = TEngine(tc, tp, batch_size=4, max_len=48, device="cpu").run(
        _requests(TRequest, tc.vocab))
    assert not ops.LAUNCH_COUNTS
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert sum(len(r.output) for r in got) == 15


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


PROTOCOLS = [dict(kind="none"), dict(kind="continuous"),
             dict(kind="periodic", period=4), dict(kind="dynamic")]
# between the distances the rounds reach
DELTA = 0.003

_STATE = {}


def _initial_states(opt_cfg):
    if "s" not in _STATE:
        p0 = _params()[0]

        def stack(x):
            return jnp.broadcast_to(x[None], (M,) + x.shape).copy()

        jstate = jax.jit(lambda p: jtrain.TrainState(
            params=jax.tree.map(stack, p),
            opt=jax.tree.map(stack, jmake(opt_cfg).init(p)),
            pstate=jproto.init_state(p, M),
            step=jnp.zeros((), jnp.int32)))(p0)
        _STATE["s"] = jstate, convert.train_state(jstate, _cfgs()[1], "cpu")
    return _STATE["s"]


def _reference_step(pcfg, opt_cfg):
    """The reference's round in its two jitted halves
    (tests/test_torch_long.py)."""
    if "local" not in _STATE:
        _STATE["local"] = jax.jit(jtrain.make_train_step(
            _cfgs()[0], jproto.ProtocolConfig(kind="none"), opt_cfg))
    protocol = jax.jit(lambda stacked, pstate: jproto.apply_protocol(
        pcfg, stacked, pstate))

    def step(state, batch):
        local, loss = _STATE["local"](state, batch)
        synced, pstate = protocol(local.params, state.pstate)
        return local._replace(params=synced, pstate=pstate), loss

    return step


@pytest.mark.parametrize("pkw", PROTOCOLS, ids=lambda p: p["kind"])
def test_train_rounds_match_reference(pkw):
    """m = 2, B 1 x S 16 a learner a round."""
    jc, tc = _cfgs()
    okw = dict(kind="sgd", lr=0.05, grad_clip=1.0)
    pkw = dict(pkw, delta=DELTA)
    jstep = _reference_step(jproto.ProtocolConfig(**pkw), JOpt(**okw))
    tstep = ttrain.make_train_step(tc, tproto.ProtocolConfig(**pkw),
                                   TOpt(**okw))
    jstate, tstate = _initial_states(JOpt(**okw))
    rng = np.random.default_rng(2)
    syncs = []
    for t in range(ROUNDS):
        toks = rng.integers(0, jc.vocab, (M, 1, 17))
        jstate, jloss = jstep(jstate, {
            "tokens": jnp.asarray(toks[..., :-1], jnp.int32),
            "labels": jnp.asarray(toks[..., 1:], jnp.int32)})
        tstate, tloss = tstep(tstate, {"tokens": _long(toks[..., :-1]),
                                       "labels": _long(toks[..., 1:])})
        label = f"round {t + 1}"
        tp, jps = tstate.pstate, jstate.pstate
        assert int(tstate.step) == int(jstate.step) == t + 1, label
        assert int(tp.step) == int(jps.step) == t + 1, label
        assert int(tp.syncs) == int(jps.syncs), label
        assert tp.bytes_sent.numpy().tobytes() == \
            np.asarray(jps.bytes_sent).tobytes(), label
        _close(tloss, jloss, label + " loss")
        _close(tp.last_divergence, jps.last_divergence, label + " divergence")
        syncs.append(int(tp.syncs))
    want = convert.train_state(jstate, tc, "cpu")
    for g, w in zip(leaves(tstate.params), leaves(want.params)):
        _close(g, w, "params")
    for g, w in zip(leaves(tp.reference), leaves(want.pstate.reference)):
        _close(g, w, "reference")
    if pkw["kind"] == "dynamic":
        assert 0 < syncs[-1] < ROUNDS, syncs


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------


def test_specs_match_reference():
    """The decode_32k caches (62 layers of the 256-wide latent and the
    32-wide rope key, bf16, at batch 128 and 32,896 slots, and each
    slot's int32 position: 150,380,248,064 B) do not fit one card;
    ``long_500k``'s window-4096 rings hold 147,292,160 B."""
    sizes = check_specs(ARCH)
    assert sizes["decode_32k"] == 62 * (128 * 32_896 * (256 + 32) * 2
                                        + 32_896 * 4) == 150_380_248_064
    assert sizes["long_500k"] == 62 * (4096 * (256 + 32) * 2 + 4096 * 4)
    assert param_count(jget(ARCH)) == 4_073_871_360
