"""The encoder-decoder family in the port against the JAX package, on the
CPU (``whisper_large_v3``).

- ``layers.sinusoidal_pos`` within the parity pair, float32 and bf16:
  XLA's CPU ``pow``, ``sin`` and ``cos`` are not PyTorch's (at 1,500 x
  1,280 the float32 tables differ by up to 3.1e-5, where a last-bit
  difference in 10000^(2i/d) is multiplied by the position).
- At ``whisper_large_v3.smoke()`` (2 encoder + 2 decoder layers, d 256,
  4 heads of 64, LayerNorm, GELU, 16 frames, tied embeddings, float32)
  with one layer's parameters: ``cross_init``'s leaves,
  ``cross_precompute``, ``cross_forward`` at S 1 (the grouped form) and
  S 7 (flat-H); ``encode`` on the plain attention and with
  ``use_flash=True`` (the reference's flash in interpret mode, the
  port's ``flash_attention`` called once a layer); the non-causal flash
  at 130 frames refused by both packages; the learned decoder positions
  past their table.
- The smoke model: ``decode_train`` and ``encdec_loss`` (bf16 too, within
  ``BF16_TOL`` of |want| plus ``BF16_TOL`` of the largest |want|),
  ``prefill_decoder`` and 6 ``decode_step_encdec`` steps with every
  layer's self and cross caches, a decode from JAX's caches
  (``convert.lm_caches``), the windowed decoder (a ring of 8 slots) past
  its ring, the decode chain against teacher forcing, and
  ``launch/serve.py``'s prefill and decode steps on a batch with
  ``frames`` (their greedy tokens equal to the reference's).
- 6 trainer rounds a protocol kind with ``frames`` in every batch;
  the trainer's CLI; ``launch.specs`` at the four shapes.

Parameters are the reference's tree filled with numpy draws from a seed
(norm scales and biases away from their init values), carried across by
``convert.lm_params`` (which hands an encoder-decoder tree to
``convert.encdec_params``).  Floats are held to the suite's parity pair
unless said otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import encdec as jed
from repro.models import layers as jlayers
from repro.models.config import param_count
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import encdec as ted
from repro_torch.models import layers as tlayers
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.tree import leaves

# the helpers, the draw and the one-thread autouse fixture are shared
from test_torch_vlm import (_close, _draw, _f32, _long, _np,  # noqa: F401
                            _one_thread, _same_leaf, _tokens)

ARCH = "whisper_large_v3"
BF16_TOL = 3e-2          # tests/test_torch_ssm.py's bf16 model tolerance
DECODE_TOL = 2e-2        # tests/test_decode.py:37
M = 2
ROUNDS = 6


def _cfgs(**kw):
    return jget(ARCH).smoke().with_(**kw), tget(ARCH).smoke().with_(**kw)


def _draw_encdec(path, leaf, rng):
    """``_draw``, with LayerNorm biases N(0, 0.1^2) too."""
    if path[-1].key == "bias":
        return jnp.asarray((0.1 * rng.normal(size=leaf.shape)).astype(
            np.float32), leaf.dtype)
    return _draw(path, leaf, rng)


_PARAMS = {}


def _params(dtype="float32", **kw):
    key = (dtype,) + tuple(sorted(kw.items()))
    if key not in _PARAMS:
        jc, tc = _cfgs(dtype=dtype, **kw)
        rng = np.random.default_rng(1)
        shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
        jp = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _draw_encdec(path, leaf, rng), shapes)
        _PARAMS[key] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[key]


_JIT = {}


def _jit(jc, name):
    if (jc, name) not in _JIT:
        _JIT[jc, name] = jax.jit(getattr(jbuild(jc), name))
    return _JIT[jc, name]


def _frames(rng, cfg, B, F=None):
    return rng.normal(size=(B, F or cfg.n_audio_frames, cfg.d_model)).astype(
        np.float32)


def _batch(rng, cfg, B, S, labels=False):
    out = {"frames": _frames(rng, cfg, B),
           "tokens": _tokens(rng, cfg.vocab, B, S)}
    if labels:
        out["labels"] = _tokens(rng, cfg.vocab, B, S)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: (_f32(v) if k == "frames" else _long(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Layers: sinusoidal positions, cross-attention, the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F, d", [(16, 256), (1500, 1280)])
def test_sinusoidal_pos_matches_reference(F, d, dtype):
    want = jlayers.sinusoidal_pos(F, d, jnp.dtype(dtype))
    got = tlayers.sinusoidal_pos(F, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (F, d)
    _close(got, want, "sinusoidal_pos")


def test_constrain_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert tlayers.constrain(x, (None, "model")) is x
    np.testing.assert_array_equal(
        np.asarray(jlayers.constrain(jnp.arange(6.0).reshape(2, 3),
                                     (None, "model"))), _np(x))


def _cross_params():
    jp, tp = _params()
    return (jax.tree.map(lambda x: x[0], jp["dec_blocks"]["cross_attn"]),
            tp["dec_blocks"][0]["cross_attn"])


def test_cross_init_leaves_match_reference():
    jc, tc = _cfgs()
    want = jattn.cross_init(jax.random.PRNGKey(0), jc, jnp.float32)
    got = tattn.cross_init(torch.Generator().manual_seed(0), tc,
                           torch.float32)
    assert sorted(got) == sorted(want)
    for k in got:
        assert sorted(got[k]) == sorted(want[k]) == ["w"]
        assert tuple(got[k]["w"].shape) == want[k]["w"].shape


@pytest.mark.parametrize("S", [1, 7])
def test_cross_forward_matches_reference(S):
    """S 1 takes ``_sdpa_grouped``, S 7 the flat-H ``_sdpa``; the keys and
    values come from ``cross_precompute`` over 16 encoder frames."""
    jc, tc = _cfgs()
    jpa, tpa = _cross_params()
    rng = np.random.default_rng(2)
    enc = _frames(rng, jc, 2)
    x = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    jk, jv = jattn.cross_precompute(jc, jpa, jnp.asarray(enc))
    tk, tv = tattn.cross_precompute(tc, tpa, _f32(enc))
    _close(tk, jk, "cross k")
    _close(tv, jv, "cross v")
    want = jattn.cross_forward(jc, jpa, jnp.asarray(x), jk, jv)
    got = tattn.cross_forward(tc, tpa, _f32(x), tk, tv)
    _close(got, want, f"cross_forward S={S}")


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_encode_matches_reference(use_flash, monkeypatch):
    """16 frames; with ``use_flash`` the reference's non-causal flash runs
    in interpret mode (one 16-row block) and the port's wrapper is called
    once an encoder layer (its plain version on the CPU)."""
    jc, tc = _cfgs(use_flash=use_flash)
    jp, tp = _params()
    calls = []
    flash = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw["causal"])
                        or flash(*a, **kw))
    frames = _frames(np.random.default_rng(3), jc, 2)
    want = jax.jit(lambda p, f: jed.encode(p, jc, f))(jp, jnp.asarray(frames))
    ops.reset_launch_counts()
    got = ted.encode(tp, tc, _f32(frames))
    assert not ops.LAUNCH_COUNTS
    assert calls == [False] * jc.encoder_layers * int(use_flash)
    _close(got, want, "encode")


def test_noncausal_flash_past_a_block_is_refused_in_both():
    """130 frames: the reference pads S to 256 and asserts (padded keys
    would leak into a non-causal softmax); the port raises ValueError.
    128 and 256 frames run."""
    jc, tc = _cfgs(use_flash=True, n_audio_frames=130)
    jp, tp = _params()
    frames = _frames(np.random.default_rng(4), jc, 1, 130)
    with pytest.raises(AssertionError):
        jed.encode(jp, jc, jnp.asarray(frames))
    with pytest.raises(ValueError, match="non-causal"):
        ted.encode(tp, tc, _f32(frames))
    for F in (128, 256):
        got = ted.encode(tp, tc, _f32(_frames(np.random.default_rng(5), jc,
                                              1, F)))
        assert got.shape == (1, F, tc.d_model)
    # a causal call at 130 rows takes the kernel's ragged edge, as before
    q = torch.randn(1, 130, 4, 64)
    out = tattn._flash_sdpa(tc, q, q, q, True)
    assert out.shape == q.shape


@pytest.mark.parametrize("offset", [0, 8185, 9000])
def test_decoder_positions_match_reference(offset):
    """Rows of the learned table, clipped at 8,191: inside, across the
    end, past it."""
    jc, _ = _cfgs()
    jp, tp = _params()
    tok = _tokens(np.random.default_rng(6), jc.vocab, 2, 12)
    want = jed._dec_embed(jp, jc, jnp.asarray(tok), offset)
    got = ted._dec_embed(tp, _long(tok), offset)
    _close(got, want, f"_dec_embed at {offset}")
    assert ted.MAX_DEC_POS == jed.MAX_DEC_POS == 8192


# ---------------------------------------------------------------------------
# The smoke model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_train_and_loss_match_reference(dtype):
    jp, tp = _params(dtype)
    jc, tc = _cfgs(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    batch = _batch(np.random.default_rng(7), jc, 2, 11, labels=True)
    want, jaux = _jit(jc, "forward")(jp, _jax_batch(batch))
    ops.reset_launch_counts()
    got, taux = tbuild(tc).forward(tp, _torch_batch(batch))
    assert not ops.LAUNCH_COUNTS
    _close(got, want, "decode_train logits", tol)
    assert float(taux) == float(jaux) == 0.0
    jl = _jit(jc, "loss")(jp, _jax_batch(batch))
    tl = tbuild(tc).loss(tp, _torch_batch(batch))
    _close(tl, jl, "encdec_loss", tol)


def _prefill_and_decode(jc, tc, jp, tp, B, S, L, steps, seed):
    """The reference's and the port's prefill then ``steps`` decode steps
    fed the reference's greedy tokens; returns the caches of both."""
    japi, tapi = jbuild(jc), tbuild(tc)
    batch = _batch(np.random.default_rng(seed), jc, B, S)
    jlog, jcache = _jit(jc, "prefill")(jp, _jax_batch(batch),
                                       japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, _torch_batch(batch),
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, "prefill logits")
    decode = _jit(jc, "decode")
    for step in range(steps):
        nxt = np.argmax(np.asarray(jlog)[:, -1, :jc.vocab], -1)[:, None]
        nxt = nxt.astype(np.int32)
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _long(nxt), S + step)
        _close(tlog, jlog, f"decode step {step}")
    return jcache, tcache


def _same_caches(tcache, jcache, tc):
    want = convert.lm_caches(jcache, tc, "cpu")
    assert len(want) == len(tcache) == tc.n_layers
    for got, w in zip(tcache, want):
        assert sorted(got) == sorted(w) == ["cross_k", "cross_v", "self"]
        _close(got["self"].k, w["self"].k, "self k")
        _close(got["self"].v, w["self"].v, "self v")
        assert torch.equal(got["self"].slot_pos, w["self"].slot_pos)
        _close(got["cross_k"], w["cross_k"], "cross k")
        _close(got["cross_v"], w["cross_v"], "cross v")
    return want


def test_prefill_and_decode_match_reference():
    """Prefill of 16 frames and 9 tokens into caches of 24, then 6 decode
    steps: logits and every layer's self and cross caches; then a decode
    from JAX's caches."""
    jp, tp = _params()
    jc, tc = _cfgs()
    S = 9
    jcache, tcache = _prefill_and_decode(jc, tc, jp, tp, 2, S, 24, 6, 8)
    want = _same_caches(tcache, jcache, tc)
    assert tcache[0]["self"].slot_pos.tolist() == list(range(S + 6)) + [
        -1] * (24 - S - 6)
    nxt = np.asarray([[7], [3]], np.int32)
    jlog, _ = _jit(jc, "decode")(jp, jcache, jnp.asarray(nxt),
                                 jnp.asarray(S + 6, jnp.int32))
    got, _ = tbuild(tc).decode(tp, want, _long(nxt), S + 6)
    _close(got, jlog, "decode from JAX's caches")


def test_windowed_decoder_past_its_ring():
    """``window`` 8 (the ``long_500k`` policy's kind of variant): a ring
    of 8 slots, a prefill of 13 tokens (the ring fill), 12 decode steps
    past the ring."""
    jp, tp = _params()
    jc, tc = _cfgs(window=8)
    jcache, tcache = _prefill_and_decode(jc, tc, jp, tp, 2, 13, 64, 12, 9)
    assert tcache[0]["self"].length == 8
    _same_caches(tcache, jcache, tc)


def test_decode_chain_matches_teacher_forcing():
    """tests/test_decode.py's contract on the encoder-decoder: the
    prefill's last logits and 5 decode steps against ``decode_train``
    over the whole sequence, within 2e-2 of the largest logit."""
    _, tp = _params()
    _, tc = _cfgs()
    api = tbuild(tc)
    B, S, steps = 2, 8, 5
    rng = np.random.default_rng(10)
    frames = _f32(_frames(rng, tc, B))
    tokens = _long(rng.integers(0, tc.vocab, (B, S + steps)))
    full, _ = api.forward(tp, {"frames": frames, "tokens": tokens})
    caches = api.init_caches(B, S + steps, device="cpu")
    logits, caches = api.prefill(tp, {"frames": frames,
                                      "tokens": tokens[:, :S]}, caches)
    for step in range(steps + 1):
        a = _np(full[:, S - 1 + step, :tc.vocab])
        b = _np(logits[:, -1, :tc.vocab])
        assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < DECODE_TOL, step
        if step < steps:
            logits, caches = api.decode(
                tp, caches, tokens[:, S + step:S + step + 1], S + step)


def test_serve_steps_match_reference():
    """``launch/serve.py``'s ``make_prefill_step`` / ``make_decode_step``
    on a batch with ``frames``: 6 greedy tokens a sample equal to the
    reference's steps'."""
    jp, tp = _params()
    jc, tc = _cfgs()
    B, S, steps = 2, 4, 6
    batch = _batch(np.random.default_rng(11), jc, B, S)
    jpre, jdec = jserve.make_prefill_step(jc), jserve.make_decode_step(jc)
    tpre, tdec = tserve.make_prefill_step(tc), tserve.make_decode_step(tc)
    jlog, jcache = jpre(jp, _jax_batch(batch),
                        jbuild(jc).init_caches(B, S + steps))
    tlog, tcache = tpre(tp, _torch_batch(batch),
                        tbuild(tc).init_caches(B, S + steps, device="cpu"))
    jtok = jnp.argmax(jlog[:, -1:, :jc.vocab], -1).astype(jnp.int32)
    ttok = torch.argmax(tlog[:, -1:, :tc.vocab], -1).to(torch.int32)
    want, got = [np.asarray(jtok)], [ttok.numpy()]
    for step in range(steps - 1):
        jtok, jcache = jdec(jp, jcache, jtok, jnp.asarray(S + step,
                                                          jnp.int32))
        ttok, tcache = tdec(tp, tcache, ttok.long(), S + step)
        want.append(np.asarray(jtok))
        got.append(ttok.numpy())
    assert np.concatenate(got, 1).tolist() == np.concatenate(want,
                                                             1).tolist()


# ---------------------------------------------------------------------------
# The trainer with frames
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
    """m = 2, each 1 x (16 frames + 12 tokens) a round, drawn as the
    reference CLI draws them (tokens, then frames)."""
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
        toks = rng.integers(0, jc.vocab, (M, 1, 13))
        fr = rng.normal(size=(M, 1, jc.n_audio_frames, jc.d_model))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                 "frames": fr.astype(np.float32)}
        jstate, jloss = jstep(jstate, _jax_batch(batch))
        tstate, tloss = tstep(tstate, _torch_batch(batch))
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


def test_trainer_cli_draws_frames(capsys):
    """``launch.train.main`` on the smoke Whisper: a batch with
    ``frames`` every step, as the reference's CLI draws it."""
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                 "--learners", "2", "--batch", "1", "--seq", "8"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nan" not in out


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------


def test_specs_match_reference():
    """Every leaf of ``input_specs`` at the four shapes and of the
    parameter specs against the reference's (its stacked layers one
    entry a layer here).  ``decode_32k``'s caches: 32 decoder layers of
    self k / v (20 heads of 64, bf16) at batch 128 and 32,896 slots, each
    slot's int32 position, and the cross k / v of 1,500 frames;
    ``long_500k``'s self caches are rings of 4,096 slots."""
    jc, tc = jget(ARCH), tget(ARCH)
    sizes = {}
    for shape in tspecs.SHAPES:
        m = 4 if shape == "train_4k" else 1
        want = jspecs.input_specs(jc, shape, m=m)
        got = tspecs.input_specs(tc, shape, m=m)
        assert sorted(got) == sorted(want), shape
        for key in got:
            if key != "caches":
                _same_leaf(got[key], want[key], (shape, key))
                continue
            w = want["caches"]
            assert len(got["caches"]) == tc.n_layers
            for c in got["caches"]:
                for f in c["self"]._fields:
                    x = getattr(w["self"], f)
                    _same_leaf(getattr(c["self"], f), jax.ShapeDtypeStruct(
                        x.shape[1:], x.dtype), (shape, f))
                for f in ("cross_k", "cross_v"):
                    _same_leaf(c[f], jax.ShapeDtypeStruct(
                        w[f].shape[1:], w[f].dtype), (shape, f))
            sizes[shape] = sum(x.numel() * x.element_size()
                               for x in leaves(got["caches"]))
    want = jspecs.param_specs(jc)
    got = tspecs.param_specs(tc)
    assert len(got["enc_blocks"]) == tc.encoder_layers
    assert len(got["dec_blocks"]) == tc.n_layers
    for key, n in (("enc_blocks", tc.encoder_layers),
                   ("dec_blocks", tc.n_layers)):
        wl = jax.tree.leaves(want[key])
        for layer in got[key]:
            assert len(leaves(layer)) == len(wl)
            for g, w in zip(leaves(layer), wl):
                _same_leaf(g, jax.ShapeDtypeStruct(w.shape[1:], w.dtype), key)
    for key in ("embed", "dec_pos", "enc_norm", "dec_norm"):
        for g, w in zip(leaves(got[key]), jax.tree.leaves(want[key])):
            _same_leaf(g, w, key)
    assert sum(x.numel() for x in leaves(got)) == sum(
        int(np.prod(w.shape)) for w in jax.tree.leaves(want)) \
        == 1_545_835_520
    for shape in tspecs.SHAPES:
        assert tspecs.variant_for(tc, shape).window == \
            jspecs.variant_for(jc, shape).window
    kv, cross = 2 * 20 * 64 * 2, 2 * 1500 * 20 * 64 * 2
    assert sizes["decode_32k"] == 32 * (128 * 32_896 * kv + 32_896 * 4
                                        + 128 * cross)
    assert sizes["long_500k"] == 32 * (4096 * kv + 4096 * 4 + cross)
    assert param_count(jc) == 1_534_607_360
