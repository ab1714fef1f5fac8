"""M-RoPE and the VLM prefix in the port against the JAX package, on the
CPU (``qwen2_vl_2b``).

- ``layers.apply_mrope`` against the reference's with streams that
  differ (an image grid of t 0, h its row, w its column, then text
  positions on three equal streams), sections (3, 2, 3) and (8, 12, 12),
  float32 within the parity pair, bf16 within one bf16 ulp (cos and sin
  of XLA's CPU and of PyTorch differ by a few float32 ulps, which may
  move a bf16 rounding); the reference's contract
  (tests/test_attention.py:29) on the port: equal streams give RoPE.
- ``gqa_forward`` (plain and flash; the reference's flash in interpret
  mode) at ``qwen2_vl_2b.smoke()`` with a (3, B, S) positions tensor and
  with 2-D positions, and a chain of ``gqa_decode`` steps and its cache.
- The smoke VLM (2 layers, d 256, 4 heads over 2 kv heads, hd 64,
  sections (8, 12, 12), 8 vision tokens, float32): ``forward_lm`` and
  ``lm_loss`` with ``embeds`` (bf16 too, within ``BF16_TOL`` of |want|
  plus ``BF16_TOL`` of the largest |want|, as tests/test_torch_ssm.py
  holds bf16); ``prefill`` with ``embeds`` and 8 decode steps at
  positions ``vision_tokens + S_text + step``, logits and every layer's
  cache; a decode from JAX's caches (``convert.lm_caches``);
  tests/test_decode.py's prefill/decode-versus-forward contract on the
  port.
- 6 trainer rounds a protocol kind with ``embeds`` in every batch
  against the reference's trainer: ``syncs``, ``bytes_sent`` and
  ``step`` exactly, floats within the parity pair.
- ``launch.specs.input_specs`` at the four shapes and the parameter
  specs: every leaf's shape and dtype the reference's.

Parameters are the reference's tree filled with numpy draws from a seed
(every bias and norm scale away from its init value), carried across by
``convert.lm_params``.  Floats are held to the suite's parity pair
(tests/conftest.py) unless said otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.launch import specs as jspecs
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.models.config import param_count
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.tree import leaves

ARCH = "qwen2_vl_2b"
BF16_TOL = 3e-2          # tests/test_torch_ssm.py's bf16 model tolerance
DECODE_TOL = 2e-2        # tests/test_decode.py:37
M = 2
ROUNDS = 6


def _cfgs(**kw):
    return jget(ARCH).smoke().with_(**kw), tget(ARCH).smoke().with_(**kw)


def _draw(path, leaf, rng):
    """A dense weight N(0, 1 / fan-in), the embedding N(0, 0.02^2),
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.2^2)."""
    name, shape = path[-1].key, leaf.shape
    if name == "table":
        v = 0.02 * rng.normal(size=shape)
    elif name == "scale":
        v = 1.0 + 0.2 * rng.normal(size=shape)
    elif name == "b":
        v = 0.1 * rng.normal(size=shape)
    else:
        v = rng.normal(size=shape) / np.sqrt(shape[-2])
    return jnp.asarray(v.astype(np.float32), leaf.dtype)


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's CPU ops on one intra-op thread (as
    tests/test_torch_long.py), restored after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _close(got, want, label, tol=None):
    """The parity pair; with ``tol`` (bf16 models) ``tol`` of |want| plus
    ``tol`` of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.all(np.isfinite(got)), label
    if tol is None:
        rtol, atol = PARITY_RTOL, PARITY_ATOL
    else:
        rtol, atol = tol, tol * float(np.max(np.abs(want), initial=1.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def _tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def _long(a):
    return torch.as_tensor(np.array(a)).long()


def _f32(a):
    return torch.as_tensor(np.array(a, np.float32))


def _grid_positions(B, rows, cols, text):
    """(3, B, S) positions of an image grid (t 0, h the row, w the
    column) followed by ``text`` tokens on three equal streams, which
    continue from the grid's largest position plus one."""
    h, w = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    img = np.stack([np.zeros(rows * cols, np.int64), h.ravel(), w.ravel()])
    start = max(rows, cols)
    txt = np.broadcast_to(np.arange(start, start + text), (3, text))
    pos = np.concatenate([img, txt], axis=1)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(3, 2, 3), (8, 12, 12)],
                         ids=lambda s: "-".join(map(str, s)))
def test_apply_mrope_matches_reference(sections, dtype):
    hd = 2 * sum(sections)
    rng = np.random.default_rng(0)
    pos3 = _grid_positions(2, 3, 4, 9)                 # S = 12 + 9
    x = rng.normal(size=(2, pos3.shape[2], 3, hd)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jlayers.apply_mrope(jx, jnp.asarray(pos3, jnp.int32), 1e6,
                               sections)
    tx = _f32(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    got = tlayers.apply_mrope(tx, _long(pos3), 1e6, sections)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        _close(got, want, "apply_mrope")
    else:        # within one bf16 ulp of the reference's
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.0 ** -7,
                                   atol=1e-6, err_msg="apply_mrope bf16")
    # the streams matter: a rotation by the text stream alone differs
    flat = tlayers.apply_rope(tx, _long(pos3[0]), 1e6)
    assert not torch.equal(flat, got)


def test_mrope_reduces_to_rope_for_equal_streams():
    """tests/test_attention.py:29 on the port."""
    rng = np.random.default_rng(0)
    x = _f32(rng.normal(size=(2, 5, 3, 16)))
    pos = torch.arange(5).expand(2, 5)
    a = tlayers.apply_rope(x, pos, 10_000.0)
    b = tlayers.apply_mrope(x, pos.expand(3, 2, 5), 10_000.0, (3, 2, 3))
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


def test_sections_must_cover_half_the_head():
    x = np.zeros((1, 2, 1, 16), np.float32)
    pos3 = np.zeros((3, 1, 2), np.int32)
    with pytest.raises(AssertionError):
        jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e4, (3, 3, 3))
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(_f32(x), _long(pos3), 1e4, (3, 3, 3))


# ---------------------------------------------------------------------------
# gqa_forward / gqa_decode with M-RoPE
# ---------------------------------------------------------------------------


def _attn_params():
    jp, tp = _params()
    return (jax.tree.map(lambda x: x[0], jp["stages"][0]["b0"]["attn"]),
            tp["layers"][0]["attn"])


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["plain", "flash"])
@pytest.mark.parametrize("streams", ["grid", "2d"])
def test_gqa_forward_with_mrope_matches_reference(streams, use_flash,
                                                 monkeypatch):
    """The flash path's kernel call is counted: on the CPU its wrapper
    runs the plain version and launches nothing."""
    jc, tc = _cfgs(use_flash=use_flash)
    calls = []
    flash = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    jpa, tpa = _attn_params()
    rng = np.random.default_rng(2)
    B = 2
    pos = _grid_positions(B, 2, 4, 12)                 # S = 20
    if streams == "2d":
        pos = pos[2]
    x = rng.normal(size=(B, pos.shape[-1], jc.d_model)).astype(np.float32)
    want, (wk, wv) = jax.jit(lambda p, x, pos: jattn.gqa_forward(
        jc, p, x, pos, return_kv=True))(jpa, jnp.asarray(x),
                                        jnp.asarray(pos, jnp.int32))
    ops.reset_launch_counts()
    got, (gk, gv) = tattn.gqa_forward(tc, tpa, _f32(x), _long(pos),
                                      return_kv=True)
    assert not ops.LAUNCH_COUNTS and len(calls) == int(use_flash)
    _close(got, want, "gqa_forward")
    _close(gk, wk, "rotated keys")
    _close(gv, wv, "values")


def test_gqa_decode_with_mrope_matches_reference():
    """A chain of 6 decode steps from an empty cache: outputs and the
    cache's k, v and slot_pos (exactly) against the reference's."""
    jc, tc = _cfgs()
    jpa, tpa = _attn_params()
    rng = np.random.default_rng(3)
    jcache = jattn.init_kv_cache(jc, 2, 8, jnp.float32)
    tcache = tattn.init_kv_cache(tc, 2, 8, torch.float32)
    decode = jax.jit(lambda p, x, t, c: jattn.gqa_decode(jc, p, x, t, c))
    for t in range(6):
        x = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        want, jcache = decode(jpa, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                              jcache)
        got, tcache = tattn.gqa_decode(tc, tpa, _f32(x), t, tcache)
        _close(got, want, f"decode step {t}")
    _close(tcache.k, jcache.k, "cache k")
    _close(tcache.v, jcache.v, "cache v")
    assert tcache.slot_pos.tolist() == np.asarray(jcache.slot_pos).tolist()


# ---------------------------------------------------------------------------
# The smoke VLM
# ---------------------------------------------------------------------------


def _vlm_batch(rng, cfg, B, S, labels=False):
    embeds = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(
        np.float32)
    out = {"embeds": embeds, "tokens": _tokens(rng, cfg.vocab, B, S)}
    if labels:
        out["labels"] = _tokens(rng, cfg.vocab, B, S)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: (_f32(v) if k == "embeds" else _long(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_with_embeds_match_reference(dtype):
    jp, tp = _params(dtype)
    jc, tc = _cfgs(dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    batch = _vlm_batch(np.random.default_rng(4), jc, 2, 13, labels=True)
    want, jaux = _jit(jc, "forward")(jp, _jax_batch(batch))
    got, taux = tbuild(tc).forward(tp, _torch_batch(batch))
    assert got.shape[1] == jc.vision_tokens + 13
    _close(got, want, "forward_lm logits", tol)
    assert float(taux) == float(jaux) == 0.0
    jl = _jit(jc, "loss")(jp, _jax_batch(batch))
    tl = tbuild(tc).loss(tp, _torch_batch(batch))
    _close(tl, jl, "lm_loss over the text positions", tol)


def test_prefill_with_embeds_and_decode_match_reference():
    """Prefill of 8 embeddings and 11 tokens, then 8 decode steps at
    positions 19 onward fed the reference's greedy tokens: logits and
    every layer's cache against JAX's.  Then a decode from JAX's own
    caches."""
    jp, tp = _params()
    jc, tc = _cfgs()
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, L = 2, 11, 32
    batch = _vlm_batch(np.random.default_rng(5), jc, B, S)
    jlog, jcache = _jit(jc, "prefill")(jp, _jax_batch(batch),
                                       japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, _torch_batch(batch),
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, "prefill logits")
    start = jc.vision_tokens + S
    decode = _jit(jc, "decode")
    for step in range(8):
        nxt = np.argmax(np.asarray(jlog)[:, -1, :jc.vocab], -1)[:, None]
        nxt = nxt.astype(np.int32)
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(start + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _long(nxt), start + step)
        _close(tlog, jlog, f"decode step {step}")
    want = convert.lm_caches(jcache, tc, "cpu")
    for got, w in zip(tcache, want):
        _close(got.k, w.k, "cache k")
        _close(got.v, w.v, "cache v")
        assert torch.equal(got.slot_pos, w.slot_pos)
    assert tcache[0].slot_pos.tolist() == list(range(start + 8)) + [-1] * (
        L - start - 8)
    nxt = np.asarray([[7], [3]], np.int32)
    want, _ = decode(jp, jcache, jnp.asarray(nxt),
                     jnp.asarray(start + 8, jnp.int32))
    got, _ = tapi.decode(tp, convert.lm_caches(jcache, tc, "cpu"),
                         _long(nxt), start + 8)
    _close(got, want, "decode from JAX's caches")


def test_prefill_and_decode_match_full_forward():
    """tests/test_decode.py:12-45 on the port: the prefill's last logits
    and one decode at position vision_tokens + S against full forwards,
    within 2e-2 of the largest logit."""
    jp, tp = _params()
    _, tc = _cfgs()
    api = tbuild(tc)
    B, S = 2, 16
    rng = np.random.default_rng(0)
    tokens = _long(rng.integers(0, tc.vocab, (B, S + 1)))
    embeds = _f32(rng.normal(size=(B, tc.vision_tokens, tc.d_model)))
    batch = {"tokens": tokens[:, :S], "embeds": embeds}
    full, _ = api.forward(tp, batch)
    full_last = _np(full[:, -1, :tc.vocab])
    caches = api.init_caches(B, S + tc.vision_tokens + 8, device="cpu")
    pre, caches = api.prefill(tp, batch, caches)
    pre_last = _np(pre[:, -1, :tc.vocab])
    assert np.max(np.abs(full_last - pre_last)) / np.max(
        np.abs(full_last)) < DECODE_TOL
    dec, _ = api.decode(tp, caches, tokens[:, S:S + 1], S + tc.vision_tokens)
    full2, _ = api.forward(tp, {"tokens": tokens, "embeds": embeds})
    want = _np(full2[:, -1, :tc.vocab])
    assert np.max(np.abs(want - _np(dec[:, -1, :tc.vocab]))) / np.max(
        np.abs(want)) < DECODE_TOL


# ---------------------------------------------------------------------------
# The trainer with embeds
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
    """The reference's round: its jitted local updates (``kind="none"``),
    then its jitted ``apply_protocol``, as ``make_train_step`` composes
    them (tests/test_torch_long.py)."""
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
def test_train_rounds_with_embeds_match_reference(pkw):
    """m = 2, each 1 x (8 embeddings + 12 tokens) a round, the batch
    drawn as the reference CLI draws it (tokens, then embeds)."""
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
        emb = rng.normal(size=(M, 1, jc.vision_tokens, jc.d_model))
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                 "embeds": emb.astype(np.float32)}
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


def test_trainer_cli_draws_embeds(capsys):
    """``launch.train.main`` on the smoke VLM: a batch with ``embeds``
    every step, as the reference's CLI draws it."""
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                 "--learners", "2", "--batch", "1", "--seq", "8"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nan" not in out


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------


def _same_leaf(got, want, label):
    assert got.device.type == "meta", label
    assert tuple(got.shape) == tuple(want.shape), label
    assert str(got.dtype)[6:] == str(want.dtype), label


def check_specs(arch: str) -> dict:
    """Every leaf of ``input_specs`` at each shape and of the parameter
    specs against the reference's ``jax.eval_shape``; returns each
    decode shape's cache bytes."""
    jc, tc = jget(arch), tget(arch)
    sizes = {}
    for shape in tspecs.SHAPES:
        m = 4 if shape == "train_4k" else 1
        want = jspecs.input_specs(jc, shape, m=m)
        got = tspecs.input_specs(tc, shape, m=m)
        assert sorted(got) == sorted(want), (arch, shape)
        for key in got:
            if key != "caches":
                _same_leaf(got[key], want[key], (arch, shape, key))
                continue
            layers = convert._layers(tspecs.variant_for(tc, shape),
                                     want["caches"])
            assert len(got["caches"]) == len(layers)
            for c, (s, r, j, kind) in zip(got["caches"], layers):
                stack = want["caches"][s][f"b{j}"]
                assert type(c).__name__ == type(stack).__name__
                assert c._fields == stack._fields
                for f in c._fields:
                    w = getattr(stack, f)
                    _same_leaf(getattr(c, f), jax.ShapeDtypeStruct(
                        w.shape[1:], w.dtype), (arch, shape, f))
            sizes[shape] = sum(x.numel() * x.element_size()
                               for x in leaves(got["caches"]))
    want = jspecs.param_specs(jc)
    layers = convert._layers(tc, want["stages"])
    got = tspecs.param_specs(tc)
    assert len(got["layers"]) == len(layers) == tc.n_layers
    for (s, r, j, _), layer in zip(layers, got["layers"]):
        wl = jax.tree.leaves(want["stages"][s][f"b{j}"])
        assert len(leaves(layer)) == len(wl)
        for g, w in zip(leaves(layer), wl):
            _same_leaf(g, jax.ShapeDtypeStruct(w.shape[1:], w.dtype), arch)
    assert sum(x.numel() for x in leaves(got)) == sum(
        int(np.prod(w.shape)) for w in jax.tree.leaves(want))
    for shape in tspecs.SHAPES:
        assert tspecs.variant_for(tc, shape).window == \
            jspecs.variant_for(jc, shape).window
    return sizes


def test_specs_match_reference():
    """The decode_32k caches (28 layers of k and v, 2 kv heads x 128, at
    batch 128 and 32,896 slots in bf16, and each slot's int32 position:
    120,732,530,688 B) do not fit one card; ``long_500k``'s rings of
    4096 slots hold 117,899,264 B."""
    sizes = check_specs(ARCH)
    assert sizes["decode_32k"] == 28 * (128 * 32_896 * 2 * 2 * 128 * 2
                                        + 32_896 * 4) == 120_732_530_688
    assert sizes["long_500k"] == 28 * (4096 * 2 * 2 * 128 * 2 + 4096 * 4)
    assert param_count(jget(ARCH)) == 1_543_852_032
