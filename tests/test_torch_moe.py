"""The MoE family in the port against the JAX package, on the CPU
(``olmoe_1b_7b``, ``granite_moe_1b_a400m``).

- ``models/moe.py`` at the smoke width (d 256, 4 experts, top 2,
  expert_ff 128) with one layer's parameters: ``moe_forward`` with
  padding (``moe_group_size`` 6 at T 16), with dropped assignments
  (``capacity_factor`` 0.5) and both; its routing (experts, positions,
  ``keep``) exactly the reference's; ``moe_forward_einsum``,
  ``moe_forward_scatter`` and ``moe_forward_dense`` at ample and tight
  capacity; ``_capacity``; ``_aux_loss``; the gradients of every MoE leaf
  and of the input.
- Ties: a router with duplicated columns (float32 and bf16), and
  ``_top_k`` over 64 quantized probabilities, select the experts in
  ``jax.lax.top_k``'s order (the lower index first).
- The reference's contracts (tests/test_moe.py) on the port: scatter
  equals einsum, grouped with G >= T equals einsum, routed equals dense
  with ample capacity, tight capacity drops.
- Both smoke models: ``forward_lm`` with its aux loss and ``lm_loss``
  (bf16 too, within ``BF16_TOL`` of |want| plus ``BF16_TOL`` of the
  largest |want|), a prefill and 6 decode steps with every layer's
  cache, a decode from JAX's caches, tests/test_decode.py's contract,
  ``LMServingEngine``'s tokens equal to JAX's; 6 trainer rounds a
  protocol kind at ``olmoe_1b_7b.smoke()``; ``launch.specs`` of both
  configs at the four shapes.

Parameters are the reference's tree filled with numpy draws from a seed
(norm scales away from one), carried across by ``convert.lm_params``.
Routing and the protocol's integers are held exactly, floats to the
suite's parity pair unless said otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.launch import train as jtrain
from repro.models import build as jbuild
from repro.models import moe as jmoe
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
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.serving.lm import LMServingEngine as TEngine
from repro_torch.serving.lm import Request as TRequest
from repro_torch.tree import leaves

# the helpers, the draw and the one-thread autouse fixture are shared
from test_torch_vlm import (_close, _draw, _f32, _long, _np,  # noqa: F401
                            _one_thread, _tokens, check_specs)

ARCHS = ("olmoe_1b_7b", "granite_moe_1b_a400m")
BF16_TOL = 3e-2          # tests/test_torch_ssm.py's bf16 model tolerance
DECODE_TOL = 2e-2        # tests/test_decode.py:37
M = 2
ROUNDS = 6


def _cfgs(arch=ARCHS[0], **kw):
    return jget(arch).smoke().with_(**kw), tget(arch).smoke().with_(**kw)


_PARAMS = {}


def _params(arch=ARCHS[0], dtype="float32"):
    if (arch, dtype) not in _PARAMS:
        jc, tc = _cfgs(arch, dtype=dtype)
        rng = np.random.default_rng(1)
        shapes = jax.eval_shape(jbuild(jc).init, jax.random.PRNGKey(0))
        jp = jax.tree_util.tree_map_with_path(
            lambda path, leaf: _draw(path, leaf, rng), shapes)
        _PARAMS[arch, dtype] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[arch, dtype]


_JIT = {}


def _jit(jc, name):
    if (jc, name) not in _JIT:
        _JIT[jc, name] = jax.jit(getattr(jbuild(jc), name))
    return _JIT[jc, name]


def _moe_params(dtype="float32"):
    """Layer 0's MoE parameters, the reference's and the port's."""
    jp, tp = _params(dtype=dtype)
    return (jax.tree.map(lambda x: x[0], jp["stages"][0]["b0"]["moe"]),
            tp["layers"][0]["moe"])


def _x(seed, B=2, S=8, d=256):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


def _reference_routing(jc, p, x):
    """The reference's grouped routing (``moe_forward``'s first half):
    expert_idx (Tp, K), positions and keep (g, G, K)."""
    B, S, d = x.shape
    T = B * S
    G = min(jc.moe_group_size, T)
    pad = (G - T % G) % G
    xt = jnp.concatenate([jnp.asarray(x).reshape(T, d),
                          jnp.zeros((pad, d), jnp.float32)])
    _, _, gates, idx = jmoe._router(jc, p, xt)
    g = (T + pad) // G
    Cg = max(int(np.ceil(G * jc.top_k / jc.n_experts * jc.capacity_factor)),
             jc.top_k)
    pos = jax.vmap(lambda fe: jmoe._positions_by_argsort(fe, jc.n_experts))(
        idx.reshape(g, G * jc.top_k)).reshape(g, G, jc.top_k)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < Cg), pad


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------


GROUPED = {"groups": {}, "padded": dict(moe_group_size=6),
           "drops": dict(capacity_factor=0.5),
           "padded_drops": dict(moe_group_size=6, capacity_factor=0.5)}


@pytest.mark.parametrize("case", list(GROUPED))
def test_moe_forward_matches_reference(case):
    """T 16 tokens: groups of 16 (``moe_group_size`` 256 > T), or of 6
    with 2 padded rows; at capacity factor 0.5 (C_g 2 or 1 for 4
    experts, top 2) assignments drop.  Routing exactly, out and aux
    within the parity pair."""
    jc, tc = _cfgs(**GROUPED[case])
    jpm, tpm = _moe_params()
    x = _x(3)
    want, jaux = jmoe.moe_forward(jc, jpm, jnp.asarray(x))
    got, taux = tmoe.moe_forward(tc, tpm, _f32(x))
    _close(got, want, f"{case}: moe_forward")
    _close(taux, jaux, f"{case}: aux")
    idx, pos, keep, pad = _reference_routing(jc, jpm, x)
    xt = _f32(x).reshape(16, -1)
    if pad:
        xt = torch.cat([xt, torch.zeros(pad, xt.shape[1])])
    _, _, gates, t_idx, t_pos, t_keep, G, Cg = tmoe.route_grouped(
        tc, tpm, xt, 16)
    assert t_idx.tolist() == idx.tolist()
    assert t_pos.tolist() == pos.tolist()
    assert t_keep.tolist() == keep.tolist()
    assert bool((gates[16:] == 0).all())
    assert (pad > 0) == ("padded" in case)
    assert (not keep.all()) == ("drops" in case)


def _tied(p, dtype):
    """The router's columns 2 and 3 copies of 0 and 1: every token's
    probabilities tie in pairs."""
    w = np.asarray(p["router"]["w"], np.float32).copy()
    w[:, 2:] = w[:, :2]
    return dict(p, router={"w": jnp.asarray(w, dtype)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_selects_lower_index_first(dtype):
    jc, tc = _cfgs(dtype=dtype)
    jpm = _tied(jax.tree.map(lambda a: a.astype(dtype), _moe_params()[0]),
                dtype)
    tpm = convert._tree(jpm, lambda a: convert._leaf(a, "cpu"))
    x = _x(4, S=16)
    xt = jnp.asarray(x, dtype).reshape(32, -1)
    _, jprobs, jg, jidx = jmoe._router(jc, jpm, xt)
    _, tprobs, tg, tidx = tmoe._router(tc, tpm, _f32(np.asarray(
        xt, np.float32)).to(getattr(torch, dtype)))
    top2 = np.sort(np.asarray(jprobs), -1)[:, ::-1][:, :2]
    assert np.all(top2[:, 0] == top2[:, 1])          # every token ties
    assert tidx.tolist() == np.asarray(jidx).tolist()
    assert bool((tidx[:, 0] < tidx[:, 1]).all())
    _close(tg, jg, "tied gates")
    want, _ = jmoe.moe_forward(jc, jpm, jnp.asarray(x, dtype))
    got, _ = tmoe.moe_forward(tc, tpm, _f32(x).to(getattr(torch, dtype)))
    _close(got, want, "tied moe_forward",
           None if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_order_on_ties_is_jax_top_k(seed):
    """64 probabilities quantized to eighths (many ties), top 8."""
    rng = np.random.default_rng(seed)
    probs = (rng.integers(0, 6, (200, 64)) / 8.0).astype(np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 8)
    gv, gi = tmoe._top_k(_f32(probs), 8)
    assert gi.tolist() == np.asarray(wi).tolist()
    assert gv.numpy().tobytes() == np.asarray(wv).tobytes()


@pytest.mark.parametrize("cap", [8.0, 0.5])
@pytest.mark.parametrize("form", ["moe_forward_einsum", "moe_forward_scatter",
                                  "moe_forward_dense"])
def test_moe_forms_match_reference(form, cap):
    jc, tc = _cfgs(capacity_factor=cap)
    jpm, tpm = _moe_params()
    x = _x(5)
    want, jaux = getattr(jmoe, form)(jc, jpm, jnp.asarray(x))
    got, taux = getattr(tmoe, form)(tc, tpm, _f32(x))
    _close(got, want, form)
    _close(taux, jaux, form + " aux")


@pytest.mark.parametrize("T", [1, 2, 5, 16, 4096])
def test_capacity_matches_reference(T):
    for kw in ({}, dict(capacity_factor=0.5), dict(capacity_factor=1.25)):
        jc, tc = _cfgs(**kw)
        assert tmoe._capacity(T, tc) == jmoe._capacity(T, jc)
    full_j, full_t = jget("olmoe_1b_7b"), tget("olmoe_1b_7b")
    assert tmoe._capacity(T, full_t) == jmoe._capacity(T, full_j)


def test_moe_contracts_on_the_port():
    """tests/test_moe.py's contracts: scatter equals einsum at ample and
    tight capacity, grouped with G >= T equals einsum, routed equals
    dense with ample capacity, tight capacity lowers the output's
    norm."""
    _, tc = _cfgs()
    _, tpm = _moe_params()
    x = _f32(_x(6))
    for cap in (8.0, 0.5):
        cfg = tc.with_(capacity_factor=cap, moe_group_size=64)
        ein, aux_e = tmoe.moe_forward_einsum(cfg, tpm, x)
        for form in (tmoe.moe_forward_scatter, tmoe.moe_forward):
            y, aux = form(cfg, tpm, x)
            np.testing.assert_allclose(_np(y), _np(ein), rtol=1e-4,
                                       atol=1e-5)
            assert float(aux) == float(aux_e)
    routed, _ = tmoe.moe_forward(tc, tpm, x)
    dense, aux_d = tmoe.moe_forward_dense(tc, tpm, x)
    np.testing.assert_allclose(_np(routed), _np(dense), rtol=1e-4, atol=1e-5)
    assert float(aux_d) == 0.0
    tight, _ = tmoe.moe_forward(tc.with_(capacity_factor=0.25), tpm, x)
    assert float(tight.norm()) < float(routed.norm())


def test_aux_loss_matches_reference():
    jc, tc = _cfgs()
    rng = np.random.default_rng(7)
    logits = (3 * rng.normal(size=(24, 4))).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    idx = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    want = jmoe._aux_loss(jc, jnp.asarray(logits), jnp.asarray(probs),
                          jnp.asarray(idx))
    got = tmoe._aux_loss(tc, _f32(logits), _f32(probs), _long(idx))
    _close(got, want, "_aux_loss")
    assert float(got) > 0


@pytest.mark.parametrize("case", ["groups", "padded_drops"])
def test_moe_gradients_match_reference(case):
    """d/d(router, wi, wg, wo, x) of sum(out * c) + aux."""
    jc, tc = _cfgs(**GROUPED[case])
    jpm, tpm = _moe_params()
    x = _x(8)
    c = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_forward(jc, p, x)
        return jnp.sum(y * jnp.asarray(c)) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jpm, jnp.asarray(x))
    tp = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
              else {"w": v["w"].clone().requires_grad_(True)})
          for k, v in tpm.items()}
    tx = _f32(x).requires_grad_(True)
    y, aux = tmoe.moe_forward(tc, tp, tx)
    (torch.sum(y * _f32(c)) + aux).backward()
    _close(tp["router"]["w"].grad, jgp["router"]["w"], "router grad")
    for name in ("wi", "wg", "wo"):
        _close(tp[name].grad, jgp[name], name + " grad")
        assert float(tp[name].grad.abs().sum()) > 0
    _close(tx.grad, jgx, "x grad")


# ---------------------------------------------------------------------------
# The smoke models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dtype):
    """Logits, the summed aux loss and ``lm_loss`` (which adds it)."""
    jp, tp = _params(arch, dtype)
    jc, tc = _cfgs(arch, dtype=dtype)
    tol = None if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(7)
    tok, lab = _tokens(rng, jc.vocab, 2, 19), _tokens(rng, jc.vocab, 2, 19)
    want, jaux = _jit(jc, "forward")(jp, {"tokens": jnp.asarray(tok)})
    ops.reset_launch_counts()
    got, taux = tbuild(tc).forward(tp, {"tokens": _long(tok)})
    assert not ops.LAUNCH_COUNTS
    _close(got, want, "forward_lm logits", tol)
    _close(taux, jaux, "aux", tol)
    assert float(taux) > 0
    jl = _jit(jc, "loss")(jp, {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(lab)})
    tl = tbuild(tc).loss(tp, {"tokens": _long(tok), "labels": _long(lab)})
    _close(tl, jl, "lm_loss", tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 13 tokens into caches of 24 (the routed path), then 6
    decode steps (the dense path) fed the reference's greedy tokens:
    logits and every layer's cache; then a decode from JAX's caches."""
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, L = 2, 13, 24
    tok = _tokens(np.random.default_rng(8), jc.vocab, B, S)
    jlog, jcache = _jit(jc, "prefill")(jp, {"tokens": jnp.asarray(tok)},
                                       japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, {"tokens": _long(tok)},
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, "prefill logits")
    decode = _jit(jc, "decode")
    for step in range(6):
        nxt = np.argmax(np.asarray(jlog)[:, -1, :jc.vocab], -1)[:, None]
        nxt = nxt.astype(np.int32)
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _long(nxt), S + step)
        _close(tlog, jlog, f"decode step {step}")
    want = convert.lm_caches(jcache, tc, "cpu")
    assert len(want) == len(tcache) == tc.n_layers
    for got, w in zip(tcache, want):
        _close(got.k, w.k, "cache k")
        _close(got.v, w.v, "cache v")
        assert torch.equal(got.slot_pos, w.slot_pos)
    nxt = np.asarray([[7], [3]], np.int32)
    want, _ = decode(jp, jcache, jnp.asarray(nxt),
                     jnp.asarray(S + 6, jnp.int32))
    got, _ = tapi.decode(tp, convert.lm_caches(jcache, tc, "cpu"),
                         _long(nxt), S + 6)
    _close(got, want, "decode from JAX's caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_full_forward(arch):
    """tests/test_decode.py:12-45 on the port: with the smoke configs'
    ample capacity (factor 8) the routed prefill and the dense decode
    compute the same function as the full forward."""
    _, tp = _params(arch)
    _, tc = _cfgs(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_tokens_match_reference(arch):
    jp, tp = _params(arch)
    jc, tc = _cfgs(arch)
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
    """``olmoe_1b_7b.smoke()``, m = 2, B 1 x S 16 a learner a round: the
    loss carries the aux loss, a sync charges the expert leaves."""
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
    if syncs[-1]:
        n_bytes = sum(x.numel() * x.element_size()
                      for x in leaves(tstate.params)) // M
        assert tp.bytes_sent.numpy().tobytes() == np.float32(
            syncs[-1] * 2 * M * n_bytes).tobytes()


# ---------------------------------------------------------------------------
# launch/specs.py and the full configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch):
    """Every leaf of ``input_specs`` at the four shapes and of the
    parameter specs against the reference's; the decode caches as the
    dense decoder's (a MoE layer's cache is its attention's)."""
    sizes = check_specs(arch)
    cfg = tget(arch)
    kv = 2 * cfg.n_kv_heads * cfg.hd * 2               # k and v, bf16
    assert sizes["decode_32k"] == cfg.n_layers * (
        128 * 32_896 * kv + 32_896 * 4)
    assert sizes["long_500k"] == cfg.n_layers * (4096 * kv + 4096 * 4)
    counts = {"olmoe_1b_7b": 6_919_618_560,
              "granite_moe_1b_a400m": 1_334_886_400}
    assert param_count(jget(arch)) == counts[arch]
    assert tbuild(cfg).cfg is cfg
