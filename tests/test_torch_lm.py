"""The port's LM stack against the JAX package's, on the CPU.

``qwen2_5_3b``'s smoke variant (fp32, 2 layers, d 256, 4 heads over 2
kv heads, hd 64, vocab 512) with the reference's own parameters
(``repro.models.build(cfg).init``) carried across by
``convert.lm_params``.  Every bias and norm scale first gets seeded
noise: at init they are zeros and ones, and a dropped bias or scale
would pass.  On the CPU the port's flash path runs the kernel's plain
version (``ref.flash_ref``); the reference's runs its Pallas kernel in
interpret mode.

Floats are held to the suite's parity pair (tests/conftest.py:42-43).
Greedy tokens must be equal wherever the reference's top-2 logit
margin exceeds that pair's tolerance at the top logit.  At these seeds
that excludes no step of the teacher-forced decode and one token of the
serving run's 21 (request 3's fifth, margin 4.7e-4), whose token agrees
all the same (``EXCLUDED``).
The bf16 smoke case is held to 3e-2, the JAX package's own bf16 flash
tolerance (tests/test_kernels_pallas.py).

The registry: every ported config (``mamba2_130m``, ``granite_8b``,
``qwen3_14b``, ``paper_kernel`` beside ``qwen2_5_3b``) has the
reference's fields and smoke variant, ``all_arch_ids`` is the
reference's; ``granite_8b`` and ``qwen3_14b`` (``qk_norm``) smoke
models against the reference's on forward, prefill (flash) and
teacher-forced decode; ``paper_kernel``'s smoke learner and protocol
through ``engine.run`` against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.configs import all_arch_ids as jall_arch_ids
from repro.configs import get as jget
from repro.core import engine as jeng
from repro.data.streams import susy_stream
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.serving.lm import LMServingEngine as JEngine
from repro.serving.lm import Request as JRequest

from repro_torch import convert
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import all_arch_ids as tall_arch_ids
from repro_torch.configs import get as tget
from repro_torch.core import engine as teng
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.serving.lm import LMServingEngine as TEngine
from repro_torch.serving.lm import Request as TRequest

ARCH = "qwen2_5_3b"
BF16_TOL = 3e-2
#: tokens whose reference top-2 margin is within the tolerance (not
#: held), measured at these seeds
EXCLUDED = {"teacher_forced": 0, "serving": 1}


def _cfgs(**kw):
    return jget(ARCH).smoke().with_(**kw), tget(ARCH).smoke().with_(**kw)


def _perturb(tree, rng):
    """Seeded noise on every bias ("b") and norm scale ("scale")."""
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


_PARAMS = {}


def _params(dtype="float32"):
    """(reference tree, port tree), perturbed, one pair per dtype."""
    if dtype not in _PARAMS:
        jc, tc = _cfgs(dtype=dtype)
        jp = _perturb(jbuild(jc).init(jax.random.PRNGKey(0)),
                      np.random.default_rng(1))
        _PARAMS[dtype] = (jp, convert.lm_params(jp, tc, "cpu"))
    return _PARAMS[dtype]


def _close(got, want, label, tol=None):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    rtol, atol = (PARITY_RTOL, PARITY_ATOL) if tol is None else (tol, tol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def _tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a)).to(torch.int64) \
        if np.issubdtype(np.asarray(a).dtype, np.integer) \
        else torch.as_tensor(np.asarray(a, np.float32))


def test_perturbation_reaches_every_bias_and_scale():
    jp, tp = _params()
    layer = tp["layers"][0]
    assert not torch.all(layer["attn"]["wq"]["b"] == 0)
    assert not torch.all(layer["norm1"]["scale"] == 1)
    assert not torch.all(tp["final_norm"]["scale"] == 1)


def test_layers_match_reference():
    jp, tp = _params()
    jc, tc = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, jc.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["b0"])
    tl = tp["layers"][0]
    _close(tlayers.rmsnorm(tl["norm1"], _t(x), jc.norm_eps),
           jlayers.rmsnorm(jl["norm1"], jnp.asarray(x), jc.norm_eps),
           "rmsnorm")
    _close(tlayers.mlp(tl["mlp"], _t(x), jc.act),
           jlayers.mlp(jl["mlp"], jnp.asarray(x), jc.act), "mlp")
    xr = rng.normal(size=(2, 5, jc.n_heads, jc.hd)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 5))
    _close(tlayers.apply_rope(_t(xr), _t(pos), jc.rope_theta),
           jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), jc.rope_theta),
           "apply_rope")


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("S", [1, 17, 129])
def test_gqa_forward_matches_reference(S, use_flash):
    jp, tp = _params()
    jc, tc = _cfgs(use_flash=use_flash)
    x = np.random.default_rng(S).normal(size=(2, S, jc.d_model))
    x = x.astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0]["b0"])["attn"]
    want, (wk, wv) = jattn.gqa_forward(jc, jl, jnp.asarray(x), return_kv=True)
    ops.reset_launch_counts()
    got, (gk, gv) = tattn.gqa_forward(tc, tp["layers"][0]["attn"], _t(x),
                                      return_kv=True)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU call launched"
    _close(got, want, f"gqa_forward S={S} flash={use_flash}")
    _close(gk, wk, "k")
    _close(gv, wv, "v")


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_lm_matches_reference(use_flash):
    jp, tp = _params()
    jc, tc = _cfgs(use_flash=use_flash)
    tok = _tokens(np.random.default_rng(3), jc.vocab, 2, 21)
    want, jaux = jax.jit(jbuild(jc).forward)(jp, {"tokens": jnp.asarray(tok)})
    got, taux = tbuild(tc).forward(tp, {"tokens": _t(tok)})
    _close(got, want, "forward_lm logits")
    assert float(taux) == float(jaux) == 0.0


def _top2_margin(logits):
    part = np.partition(logits, -2, axis=-1)
    return part[..., -1] - part[..., -2], part[..., -1]


def _holds(margin, top):
    """Whether the tokens must agree: the margin exceeds the pair's
    tolerance at the top logit."""
    return margin > PARITY_ATOL + PARITY_RTOL * np.abs(top)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_cache_and_teacher_forced_decode(use_flash):
    jp, tp = _params()
    jc, tc = _cfgs(use_flash=use_flash)
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, steps, L = 2, 19, 6, 32
    tok = _tokens(np.random.default_rng(4), jc.vocab, B, S)
    jlog, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(tok)},
                                         japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, {"tokens": _t(tok)},
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, "prefill last-token logits")

    def check_caches(label):
        for i, c in enumerate(tcache):
            ref = jax.tree.map(lambda a: a[i], jcache[0]["b0"])
            _close(c.k, ref.k, f"{label} cache k layer {i}")
            _close(c.v, ref.v, f"{label} cache v layer {i}")
            np.testing.assert_array_equal(c.slot_pos.numpy(), ref.slot_pos)

    check_caches("prefill")
    decode = jax.jit(japi.decode)
    excluded = 0
    for step in range(steps):
        # teacher forcing: both sides take the reference's greedy token
        ref_logits = np.asarray(jlog, np.float32)[:, -1, :jc.vocab]
        margin, top = _top2_margin(ref_logits)
        nxt = np.argmax(ref_logits, axis=-1).astype(np.int32)[:, None]
        mine = tlog[:, -1, :tc.vocab].argmax(-1).numpy()
        held = _holds(margin, top)
        excluded += int(np.sum(~held))
        np.testing.assert_array_equal(mine[held], nxt[held, 0])
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _t(nxt), S + step)
        _close(tlog, jlog, f"decode step {step} logits")
    check_caches("decode")
    assert excluded == EXCLUDED["teacher_forced"]


def _requests(cls, vocab, eos=None):
    """Five requests for batches of 3: two batches (the second filled
    with a dummy), ragged prompts, one ``max_new_tokens=0``."""
    rng = np.random.default_rng(5)
    spec = [(5, 8), (9, 5), (3, 0), (7, 6), (4, 4)]
    return [cls(uid=i, prompt=_tokens(rng, vocab, n), max_new_tokens=m,
                eos_token=eos if i == 0 else None)
            for i, (n, m) in enumerate(spec)]


def _reference_steps(jc, jp, reqs, B, L):
    """Replays the reference engine's batches with its own tokens:
    {uid: [(margin, top logit)] per emitted token}."""
    api = jbuild(jc)
    prefill, decode = jax.jit(api.prefill), jax.jit(api.decode)
    out = {}
    for b0 in range(0, len(reqs), B):
        batch = reqs[b0:b0 + B]
        S = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.prompt):] = r.prompt
        logits, caches = prefill(jp, {"tokens": jnp.asarray(toks)},
                                 api.init_caches(B, L))
        for step in range(max(len(r.output) for r in batch)):
            lg = np.asarray(logits, np.float32)[:, -1, :jc.vocab]
            margin, top = _top2_margin(lg)
            nxt = np.zeros((B, 1), np.int32)
            for i, r in enumerate(batch):
                if step < len(r.output):
                    out.setdefault(r.uid, []).append((margin[i], top[i]))
                    assert r.output[step] == int(np.argmax(lg[i]))
                    nxt[i, 0] = r.output[step]
            logits, caches = decode(jp, caches, jnp.asarray(nxt),
                                    jnp.asarray(S + step, jnp.int32))
    return out


def test_serving_engine_outputs_by_uid():
    jp, tp = _params()
    jc, tc = _cfgs()
    B, L = 3, 32
    # the eos of request 0: the first token it produces without one
    # from its third on that it has not produced before
    out = TEngine(tc, tp, batch_size=B, max_len=L, device="cpu").run(
        _requests(TRequest, tc.vocab))[0].output
    eos = next(t for i, t in enumerate(out) if i >= 2 and t not in out[:i])
    want = JEngine(jc, jp, batch_size=B, max_len=L).run(
        _requests(JRequest, jc.vocab, eos))
    ops.reset_launch_counts()
    got = TEngine(tc, tp, batch_size=B, max_len=L, device="cpu").run(
        _requests(TRequest, tc.vocab, eos))
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    assert [r.uid for r in got] == [r.uid for r in want] == [0, 1, 2, 3, 4]
    wmap = {r.uid: r for r in want}
    assert 3 <= len(wmap[0].output) < 8 and wmap[0].output[-1] == eos, \
        "request 0 must stop at its eos"
    assert wmap[2].output == [] and [r.output for r in got][2] == []
    steps = _reference_steps(jc, jp, want, B, L)
    excluded = 0
    for r in got:
        ref = wmap[r.uid]
        assert r.done and r.latency_s > 0.0
        for step, (tok, ref_tok) in enumerate(zip(r.output, ref.output)):
            margin, top = steps[r.uid][step]
            if not _holds(margin, top):
                excluded += 1
                if tok != ref_tok:      # later tokens follow another prefix
                    break
                continue
            assert tok == ref_tok, (r.uid, step, r.output, ref.output)
        else:
            assert len(r.output) == len(ref.output), (r.uid, r.output,
                                                     ref.output)
    assert excluded == EXCLUDED["serving"]


def test_bf16_smoke_matches_reference():
    jp, tp = _params("bfloat16")
    jc, tc = _cfgs(dtype="bfloat16", use_flash=True)
    assert tp["layers"][0]["mlp"]["wi"]["w"].dtype == torch.bfloat16
    japi, tapi = jbuild(jc), tbuild(tc)
    tok = _tokens(np.random.default_rng(6), jc.vocab, 2, 17)
    want, _ = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(tok)})
    got, _ = tapi.forward(tp, {"tokens": _t(tok)})
    _close(got, want, "bf16 forward_lm", tol=BF16_TOL)
    jlog, _ = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(tok)},
                                    japi.init_caches(2, 24))
    tlog, _ = tapi.prefill(tp, {"tokens": _t(tok)},
                           tapi.init_caches(2, 24, device="cpu"))
    _close(tlog, jlog, "bf16 prefill logits", tol=BF16_TOL)


# The MoE family and the encoder-decoder on this file's smoke config
FAMILIES = (dict(arch_type="moe", n_experts=4, top_k=2, expert_ff=64),
            dict(encoder_layers=2, n_audio_frames=8))


def _family_batch(cfg, rng):
    toks = rng.integers(0, cfg.vocab, (2, 7))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


def test_moe_and_encdec_families_match_reference():
    """Each family builds from a seed and gives a finite loss, and from the
    reference's parameters the reference's loss (the MoE's with its aux
    loss).  Only a name the registry does not know raises."""
    jc, tc = _cfgs()
    for kw in FAMILIES:
        jcf, tcf = jc.with_(**kw), tc.with_(**kw)
        batch = _family_batch(tcf, np.random.default_rng(0))
        tb = {k: (torch.as_tensor(v) if k == "frames"
                  else torch.as_tensor(v).long()) for k, v in batch.items()}
        own = tbuild(tcf).loss(tbuild(tcf).init(0, device="cpu"), tb)
        assert np.isfinite(float(own)), kw
        jp = jbuild(jcf).init(jax.random.PRNGKey(0))
        want = jbuild(jcf).loss(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        got = tbuild(tcf).loss(convert.lm_params(jp, tcf, "cpu"), tb)
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL)
    with pytest.raises(KeyError, match="unknown architecture"):
        tget("no_such_arch")


# ---------------------------------------------------------------------------
# The registry and the configs that need no new model code
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert tall_arch_ids() == jall_arch_ids()
    assert tall_arch_ids(include_paper=True) == jall_arch_ids(
        include_paper=True)
    assert set(ARCH_IDS) == {"qwen2_5_3b", "mamba2_130m", "granite_8b",
                           "qwen3_14b", "paper_kernel", "recurrentgemma_9b",
                           "qwen2_vl_2b", "minicpm3_4b", "olmoe_1b_7b",
                           "granite_moe_1b_a400m", "whisper_large_v3"}
    assert set(ARCH_IDS) == set(jall_arch_ids(include_paper=True))
    for name in ARCH_IDS:
        want, got = jget(name), tget(name)
        if name == "paper_kernel":
            assert (got.name, got.arch_type, got.m) == (
                want.name, want.arch_type, want.m)
            for part in ("learner", "protocol"):
                for cfg_t, cfg_j in ((got, want), (got.smoke(), want.smoke())):
                    assert dataclasses.asdict(getattr(cfg_t, part)) == \
                        dataclasses.asdict(getattr(cfg_j, part)), part
            assert (got.smoke().m, got.smoke().learner.budget) == (2, 16)
            continue
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert dataclasses.asdict(got.smoke()) == \
            dataclasses.asdict(want.smoke()), name
        tbuild(got)                       # every ported model builds
    assert tget("mamba2-130m") is tget("mamba2_130m")
    assert tget("qwen3-14b") is tget("qwen3_14b")


_DENSE = {}


def _dense(arch):
    """(reference cfg, port cfg, reference params, port params) of a
    dense config's smoke model, biases and norm scales (``q_norm`` and
    ``k_norm`` too) perturbed."""
    if arch not in _DENSE:
        jc = jget(arch).smoke().with_(use_flash=True)
        tc = tget(arch).smoke().with_(use_flash=True)
        jp = _perturb(jbuild(jc).init(jax.random.PRNGKey(0)),
                      np.random.default_rng(1))
        _DENSE[arch] = (jc, tc, jp, convert.lm_params(jp, tc, "cpu"))
    return _DENSE[arch]


@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_14b"])
def test_dense_config_smoke_matches_reference(arch):
    """Forward, prefill on the flash path and 4 teacher-forced decode
    steps against the reference's on one set of parameters (float32;
    the dense decoder in bf16 is ``test_bf16_smoke_matches_reference``'s)."""
    jc, tc, jp, tp = _dense(arch)
    if arch == "qwen3_14b":
        assert not torch.all(tp["layers"][0]["attn"]["q_norm"]["scale"] == 1)
    japi, tapi = jbuild(jc), tbuild(tc)
    B, S, L = 2, 19, 32
    tok = _tokens(np.random.default_rng(7), jc.vocab, B, S)
    want, _ = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(tok)})
    got, _ = tapi.forward(tp, {"tokens": _t(tok)})
    _close(got, want, f"{arch} forward_lm")
    jlog, jcache = jax.jit(japi.prefill)(jp, {"tokens": jnp.asarray(tok)},
                                         japi.init_caches(B, L))
    tlog, tcache = tapi.prefill(tp, {"tokens": _t(tok)},
                                tapi.init_caches(B, L, device="cpu"))
    _close(tlog, jlog, f"{arch} prefill")
    decode = jax.jit(japi.decode)
    for step in range(4):
        nxt = np.argmax(np.asarray(jlog, np.float32)[:, -1, :jc.vocab],
                        axis=-1).astype(np.int32)[:, None]
        jlog, jcache = decode(jp, jcache, jnp.asarray(nxt),
                              jnp.asarray(S + step, jnp.int32))
        tlog, tcache = tapi.decode(tp, tcache, _t(nxt), S + step)
        _close(tlog, jlog, f"{arch} decode step {step}")


def test_paper_kernel_run_matches_reference(backend_parity):
    """``paper_kernel``'s smoke learner (SV, budget 16, d 8) and protocol
    (dynamic, delta 1) at its m = 2 through ``engine.run``, 40 rounds of
    ``susy_stream``: the same sync rounds and bytes, losses within the
    parity pair."""
    jc, tc = jget("paper_kernel").smoke(), tget("paper_kernel").smoke()
    X, Y = susy_stream(40, tc.m, d=tc.learner.dim, seed=0)
    want = jeng.run(jc.learner, jc.protocol, X, Y, backend="reference")
    got = teng.run(tc.learner, tc.protocol, X, Y, backend="reference",
                   device="cpu")
    assert got.num_syncs == want.num_syncs > 0
    np.testing.assert_array_equal(got.sync_rounds, want.sync_rounds)
    np.testing.assert_array_equal(got.cumulative_bytes, want.cumulative_bytes)
    np.testing.assert_array_equal(got.cumulative_errors,
                                  want.cumulative_errors)
    backend_parity(got.cumulative_loss, want.cumulative_loss, "loss")
