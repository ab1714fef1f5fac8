"""Long-context serving in the port against the JAX package, on the CPU:
the sliding-window ring cache, the hybrid family (``recurrentgemma_9b``)
and ``launch/specs.py``'s long-context policy.

- The reference's ``test_sliding_window_decode_ring_buffer``
  (tests/test_decode.py:51-69), both cases (``recurrentgemma_9b`` and
  ``qwen2_5_3b`` smoke, window 8, S 24): the decode past the window
  against the JAX package's logits (parity pair) and against the
  port's own windowed full forward (the reference's 2e-2).
- ``_fill_kv_cache``'s ring layout against the reference's: ``k``,
  ``v`` and ``slot_pos`` exactly, at prompts shorter than, equal to and
  past the ring (one and three times round).
- ``convert.lm_params`` over the bf16 hybrid's stages, plain and
  stacked: ``Lambda`` stays float32, every number the reference's.
- The smoke hybrid (3 layers, (rglru, rglru, attn), d 256, lru 256,
  float32) at the ring test's window of 8: ``forward_lm`` and
  ``lm_loss``; the ring test's 24-token prefill (the ring path) and 8
  teacher-forced decode steps (the ring wraps again), logits and every
  layer's cache against JAX's (carried across by
  ``convert.lm_caches``), then a decode from JAX's own caches;
  ``LMServingEngine``'s tokens on prompts longer than the window; no
  kernel of the port launches.
- ``specs.input_specs`` for both architectures at all four shapes,
  ``param_specs`` and ``stacked_param_specs``: every leaf's shape and
  dtype the reference's ``jax.eval_shape``'s (caches per layer against
  the reference's per-stage stacks); ``variant_for``.
- 6 trainer rounds of the smoke hybrid a protocol kind (m 2, sgd, lr
  0.05, clip 1.0) against the reference's trainer: ``syncs``,
  ``bytes_sent`` and ``step`` exactly, floats within the parity pair.
  The reference's round is its ``make_train_step`` body in its two
  halves, each the reference's own jitted function: the local updates
  (``make_train_step`` with ``kind="none"``, whose protocol is the
  identity) and then ``apply_protocol`` of the kind on the local
  parameters and the round's protocol state.  The model's trace and
  compile (seconds on the CPU) is then paid once, not once a kind.

The parameters are the reference's tree (``jax.eval_shape`` of its
``init``) filled with numpy draws from a seed, every bias and norm
scale away from its init value, ``Lambda`` by the Griffin init; they
reach the port through ``convert.lm_params``.  Compiled JAX functions
are shared between tests of one shape (``_jit``): XLA's compiles are
most of this file's time.
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
from repro.models import transformer as jtransformer
from repro.optim import OptimizerConfig as JOpt
from repro.optim import make as jmake
from repro.serving.lm import LMServingEngine as JEngine
from repro.serving.lm import Request as JRequest

from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.serving.lm import LMServingEngine as TEngine
from repro_torch.serving.lm import Request as TRequest
from repro_torch.tree import leaves

ARCH = "recurrentgemma_9b"
DECODE_TOL = 2e-2                 # tests/test_decode.py:37
M = 2
ROUNDS = 6
WINDOW = 8                        # tests/test_decode.py:56


def _cfgs(arch=ARCH, **kw):
    kw.setdefault("window", WINDOW)
    return jget(arch).smoke().with_(**kw), tget(arch).smoke().with_(**kw)


def _draw(path, leaf, rng):
    """One leaf of the reference's tree: a dense or conv weight
    N(0, 1 / fan-in), the embedding N(0, 0.02^2), biases N(0, 0.1^2),
    norm scales 1 + N(0, 0.2^2), ``Lambda`` softplus^-1(-log(u) / 8) for
    u ~ U[0.9, 0.999] (the reference's init)."""
    name, shape = path[-1].key, leaf.shape
    if name == "Lambda":
        v = np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, shape)) / 8))
    elif name == "table":
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
    """The port's CPU ops on one intra-op thread, restored after each
    test.  Under the suite's parallel workers every parallel region of
    a many-thread pool waits on descheduled threads: a smoke trainer
    round took 16 s there, and 0.13 s on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_PARAMS = {}


def _params(arch=ARCH):
    """The reference's parameter tree with numpy draws, and the port's
    copy (a window does not change them)."""
    if arch not in _PARAMS:
        jc, tc = _cfgs(arch)
        rng = np.random.default_rng(1)
        shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
        jp = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _draw(path, leaf, rng), shapes)
        _PARAMS[arch] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[arch]


_JIT = {}


def _jit(jc, name):
    """``jax.jit`` of the reference api's ``name`` for ``jc``, shared."""
    if (jc, name) not in _JIT:
        _JIT[jc, name] = jax.jit(getattr(jbuild(jc), name))
    return _JIT[jc, name]


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _close(got, want, label):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.all(np.isfinite(got)), label
    np.testing.assert_allclose(got, want, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                               err_msg=label)


def _tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def _long(a):
    return torch.as_tensor(a).long()


# ---------------------------------------------------------------------------
# The ring cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "qwen2_5_3b"])
def test_sliding_window_decode_ring_buffer(arch):
    """Decode far past the window: the ring keeps only the last window
    positions and still matches the windowed full forward."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S = 1, 24
    tokens = _tokens(np.random.default_rng(0), jc.vocab, B, S + 1)
    _, jcache = _jit(jc, "prefill")(jp, {"tokens": jnp.asarray(
        tokens[:, :S])}, japi.init_caches(B, S + 8))
    want, _ = _jit(jc, "decode")(jp, jcache, jnp.asarray(tokens[:, S:]),
                                 jnp.asarray(S, jnp.int32))
    caches = tapi.init_caches(B, S + 8, device="cpu")
    ring = [c for c in caches if isinstance(c, tattn.KVCache)]
    assert ring and all(c.length == 8 for c in ring)
    ops.reset_launch_counts()
    _, caches = tapi.prefill(tp, {"tokens": _long(tokens[:, :S])}, caches)
    got, _ = tapi.decode(tp, caches, _long(tokens[:, S:]), S)
    assert not ops.LAUNCH_COUNTS
    _close(got, want, f"{arch} decode at {S}")
    full, _ = tapi.forward(tp, {"tokens": _long(tokens)})
    a, b = _np(got)[:, -1, :tc.vocab], _np(full)[:, -1, :tc.vocab]
    assert np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9) < DECODE_TOL


@pytest.mark.parametrize("S", [5, 8, 13, 24])
def test_ring_fill_matches_reference(S):
    """The prefill's cache write: slots 0 .. S-1 when the prompt fits,
    else token p in slot p % 8 for the last 8 tokens; exactly the
    reference's ``k``, ``v`` and ``slot_pos``."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(S)
    k = rng.normal(size=(2, S, 1, 64)).astype(np.float32)
    v = rng.normal(size=(2, S, 1, 64)).astype(np.float32)
    L = min(S + 3, 8)
    want = jtransformer._fill_kv_cache(
        jc, jattn.init_kv_cache(jc, 2, L, jnp.float32),
        (jnp.asarray(k), jnp.asarray(v)), S)
    cache = tattn.init_kv_cache(tc, 2, L, torch.float32)
    got = ttransformer._fill_kv_cache(tc, cache, (torch.as_tensor(k),
                                                  torch.as_tensor(v)), S)
    assert got is cache                           # written in place
    for field in ("k", "v", "slot_pos"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), (S, field)
    if S > 8:
        assert sorted(got.slot_pos.tolist()) == list(range(S - 8, S))


def test_decode_write_wraps_the_ring():
    """``gqa_decode`` writes slot pos % L in place and takes any pos >= 0
    on a ring; a full cache still refuses a pos past its end."""
    jc, tc = _cfgs("qwen2_5_3b")
    jp, tp = _params("qwen2_5_3b")
    p_j, p_t = jp["stages"][0]["b0"]["attn"], tp["layers"][0]["attn"]
    p_j = jax.tree.map(lambda a: a[0], p_j)
    rng = np.random.default_rng(7)
    jcache = jattn.init_kv_cache(jc, 2, 8, jnp.float32)
    tcache = tattn.init_kv_cache(tc, 2, 8, torch.float32)
    step = jax.jit(lambda p, x, pos, c: jattn.gqa_decode(jc, p, x, pos, c,
                                                         window=8))
    for pos in range(19):
        x = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
        jy, jcache = step(p_j, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                          jcache)
        ty, same = tattn.gqa_decode(tc, p_t, torch.as_tensor(x), pos, tcache,
                                    window=8)
        assert same is tcache
        _close(ty, jy, f"decode at {pos}")
        assert tcache.slot_pos.tolist() == np.asarray(
            jcache.slot_pos).tolist()
        _close(tcache.k, jcache.k, f"k at {pos}")
    with pytest.raises(ValueError, match="outside"):
        tattn.gqa_decode(tc, p_t, torch.zeros(2, 1, tc.d_model), 8,
                         tattn.init_kv_cache(tc, 2, 8, torch.float32))
    with pytest.raises(ValueError, match="outside"):
        tattn.gqa_decode(tc, p_t, torch.zeros(2, 1, tc.d_model), -1, tcache,
                         window=8)


# ---------------------------------------------------------------------------
# The smoke hybrid model
# ---------------------------------------------------------------------------


def test_forward_and_loss_match_reference():
    jp, tp = _params()
    jc, tc = _cfgs()
    assert tc.pattern == ("rglru", "rglru", "attn") and tc.window == WINDOW
    assert [sorted(layer) for layer in tp["layers"]] == [
        ["mlp", "norm1", "norm2", "rglru"]] * 2 + [
        ["attn", "mlp", "norm1", "norm2"]]
    assert tp["layers"][0]["rglru"]["Lambda"].dtype == torch.float32
    rng = np.random.default_rng(3)
    tok, lab = (_tokens(rng, jc.vocab, 2, 21) for _ in range(2))
    tapi = tbuild(tc)
    want, _ = _jit(jc, "forward")(jp, {"tokens": jnp.asarray(tok)})
    ops.reset_launch_counts()
    got, aux = tapi.forward(tp, {"tokens": _long(tok)})
    assert not ops.LAUNCH_COUNTS and float(aux) == 0.0
    _close(got, want, "forward_lm logits (window 8 of 21)")
    jl = _jit(jc, "loss")(jp, {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(lab)})
    _close(tapi.loss(tp, {"tokens": _long(tok), "labels": _long(lab)}), jl,
           "lm_loss")


def test_bf16_hybrid_tree_keeps_its_float32_lambda():
    """``convert.lm_params`` over the bf16 hybrid's stages (and stacked,
    as the trainer's): every leaf in the reference's type, ``Lambda``
    float32 among bf16 weights, the numbers unchanged."""
    jc, tc = _cfgs(dtype="bfloat16")
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _draw(path, leaf, rng), shapes)
    layers = convert._layers(tc, jp["stages"])
    for stacked in (False, True):
        tree = jax.tree.map(lambda x: jnp.stack([x, x]), jp) if stacked \
            else jp
        tp = convert.lm_params(tree, tc, "cpu", stacked=stacked)
        assert tp["layers"][0]["rglru"]["Lambda"].dtype == torch.float32
        assert tp["layers"][0]["rglru"]["w_a"]["w"].dtype == torch.bfloat16
        for (s, r, j, _), layer in zip(layers, tp["layers"]):
            want = jax.tree.leaves(jp["stages"][s][f"b{j}"])
            for g, w in zip(leaves(layer), want):
                assert str(g.dtype)[6:] == str(w.dtype)
                g = g.float().numpy()
                assert np.array_equal(g[0] if stacked else g,
                                      np.asarray(w[r], np.float32))


def test_prefill_and_decode_match_reference():
    """The ring test's shapes (B 1, a 24-token prefill into rings of 8,
    the ring path), then 8 teacher-forced decode steps (positions 24 to
    31 overwrite the whole ring); logits every step, then every layer's
    cache, against JAX's; then a decode from JAX's own caches."""
    jp, tp = _params()
    jc, tc = _cfgs()
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, L = 1, 24, 32
    tok = _tokens(np.random.default_rng(4), jc.vocab, B, S + 8)
    jlog, jcache = _jit(jc, "prefill")(
        jp, {"tokens": jnp.asarray(tok[:, :S])}, japi.init_caches(B, L))
    tcache = tapi.init_caches(B, L, device="cpu")
    assert [type(c).__name__ for c in tcache] == [
        "LRUState", "LRUState", "KVCache"] and tcache[2].length == WINDOW
    tlog, tcache = tapi.prefill(tp, {"tokens": _long(tok[:, :S])}, tcache)
    _close(tlog, jlog, "prefill logits")
    decode = _jit(jc, "decode")
    for step in range(8):
        pos = S + step
        nxt = tok[:, pos:pos + 1]
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(pos, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _long(nxt), pos)
        _close(tlog, jlog, f"decode {pos}")
    want = convert.lm_caches(jcache, tc, "cpu")
    for i, (g, w) in enumerate(zip(tcache, want)):
        assert type(g) is type(w)
        for field in g._fields:
            gf, wf = getattr(g, field), getattr(w, field)
            assert gf.dtype == wf.dtype, (i, field)
            if field == "slot_pos":
                assert torch.equal(gf, wf)
            else:
                _close(gf, wf, f"layer {i} {field}")
    assert sorted(tcache[2].slot_pos.tolist()) == list(range(S + 8 - WINDOW,
                                                             S + 8))
    nxt = np.asarray([[3]], np.int32)
    want, _ = decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(S + 8))
    got, _ = tapi.decode(tp, convert.lm_caches(jcache, tc, "cpu"),
                         _long(nxt), S + 8)
    _close(got, want, "decode from JAX's caches")


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    spec = [(37, 5), (3, 4), (50, 6)]
    return [cls(uid=i, prompt=_tokens(rng, vocab, n), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)]


def test_serving_engine_tokens_match_reference():
    """A batch of 4 with a dummy, left-padded to 50 tokens, past the
    window of 8 (rings of 8 at max_len 64): every token the
    reference's."""
    jp, tp = _params()
    jc, tc = _cfgs()
    want = JEngine(jc, jp, batch_size=4, max_len=64).run(
        _requests(JRequest, jc.vocab))
    ops.reset_launch_counts()
    got = TEngine(tc, tp, batch_size=4, max_len=64, device="cpu").run(
        _requests(TRequest, tc.vocab))
    assert not ops.LAUNCH_COUNTS
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert sum(len(r.output) for r in got) == 15


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------


def _same_leaf(got, want, label):
    assert got.device.type == "meta", label
    assert tuple(got.shape) == tuple(want.shape), label
    assert str(got.dtype)[6:] == str(want.dtype), label


def test_specs_match_reference():
    """Every leaf of ``input_specs`` at each shape for both
    architectures, and of the parameter specs, has the shape and dtype
    of the reference's; decode caches per layer against the reference's
    per-stage stacks.  The full-size decode caches: 3,357,638,656 B at
    ``decode_32k`` for the hybrid (its ring holds 2048 slots), 151,584,768
    B at ``long_500k`` for the dense arch (rings of 4096)."""
    sizes = {}
    for arch in (ARCH, "qwen2_5_3b"):
        jc, tc = jget(arch), tget(arch)
        for shape in tspecs.SHAPES:
            want, got = jspecs.input_specs(jc, shape, m=4 if shape ==
                                           "train_4k" else 1), \
                tspecs.input_specs(tc, shape, m=4 if shape == "train_4k"
                                   else 1)
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
                    for f in c._fields:
                        w = getattr(stack, f)
                        _same_leaf(getattr(c, f), jax.ShapeDtypeStruct(
                            w.shape[1:], w.dtype), (arch, shape, f))
                sizes[arch, shape] = sum(x.numel() * x.element_size()
                                         for x in leaves(got["caches"]))
        # the reference's stacked specs are its specs with a leading m
        want = jspecs.param_specs(jc)
        layers = convert._layers(tc, want["stages"])
        for got, lead in ((tspecs.param_specs(tc), ()),
                          (tspecs.stacked_param_specs(tc, 2), (2,))):
            assert len(got["layers"]) == len(layers) == tc.n_layers
            for (s, r, j, _), layer in zip(layers, got["layers"]):
                wl = jax.tree.leaves(want["stages"][s][f"b{j}"])
                assert len(leaves(layer)) == len(wl)
                for g, w in zip(leaves(layer), wl):
                    _same_leaf(g, jax.ShapeDtypeStruct(lead + w.shape[1:],
                                                       w.dtype), arch)
            for key in ("embed", "final_norm"):
                for g, w in zip(leaves(got[key]), jax.tree.leaves(want[key])):
                    _same_leaf(g, jax.ShapeDtypeStruct(lead + w.shape,
                                                       w.dtype), (arch, key))
    assert sizes[ARCH, "decode_32k"] == 3_357_638_656
    assert sizes["qwen2_5_3b", "long_500k"] == 151_584_768
    assert sizes[ARCH, "long_500k"] == 26_329_088
    hybrid, dense = tget(ARCH), tget("qwen2_5_3b")
    for shape in tspecs.SHAPES:
        assert tspecs.variant_for(hybrid, shape) is hybrid
        want = jspecs.variant_for(jget("qwen2_5_3b"), shape)
        got = tspecs.variant_for(dense, shape)
        assert got.window == want.window == (4096 if shape == "long_500k"
                                             else 0)
    assert tspecs.CACHE_MARGIN == jspecs.CACHE_MARGIN
    assert tspecs.SHAPES == jspecs.SHAPES


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


PROTOCOLS = [dict(kind="none"), dict(kind="continuous"),
             dict(kind="periodic", period=4), dict(kind="dynamic")]
# between the distances the rounds reach (after one clipped sgd step a
# learner is lr^2 = 2.5e-3 from the reference)
DELTA = 0.0035


_STATE = {}


def _initial_states(opt_cfg):
    """The reference's TrainState of m copies of the perturbed model and
    the port's copy of it (the port's step writes nothing in place, so
    every protocol kind starts from the same one)."""
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
    """The reference's round for ``pcfg``: its local updates, then its
    ``apply_protocol``, as ``make_train_step`` composes them."""
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
    """m = 2, B 1 x S 24 a learner a round (past the window of 8)."""
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
        toks = rng.integers(0, jc.vocab, (M, 1, 25))
        jstate, jloss = jstep(jstate, {
            "tokens": jnp.asarray(toks[..., :-1], jnp.int32),
            "labels": jnp.asarray(toks[..., 1:], jnp.int32)})
        tstate, tloss = tstep(tstate, {"tokens": torch.as_tensor(toks[..., :-1]),
                                       "labels": torch.as_tensor(toks[..., 1:])})
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
        assert g.dtype == w.dtype
        _close(g, w, "params")
    for g, w in zip(leaves(tp.reference), leaves(want.pstate.reference)):
        _close(g, w, "reference")
    if pkw["kind"] == "dynamic":
        assert 0 < syncs[-1] < ROUNDS, syncs
    one = jax.tree.map(lambda x: x[0], jstate.params)
    assert tproto.model_bytes(convert.lm_params(one, tc, "cpu")) == \
        jproto.model_bytes(one)
