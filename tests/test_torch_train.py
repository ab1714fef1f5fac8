"""The port's LM trainer pieces against the JAX package's, on the CPU.

``qwen2_5_3b``'s smoke variant (fp32, 2 layers, d 256, vocab 512) with
the reference's own parameters carried across (``convert.train_state``
/ ``convert.lm_params``), every bias and norm scale first given seeded
noise as tests/test_torch_lm.py does.

- ``lm_loss`` and each learner's gradients within the suite's parity
  pair (tests/conftest.py);
- the ports of tests/test_models_smoke.py's two train-step tests for
  the dense family; an architecture the port lacks raises;
- checkpoints: a file the JAX package writes restores in the port and
  the other way round (bf16 included), a port ``TrainState`` round
  trips bitwise through ``save_step`` / ``latest_step``, and a shape or
  leaf-count mismatch raises;
- the ``main()`` CLI on the CPU, whose ``--arch`` defaults to
  ``mamba2_130m`` as the reference's does;
- ``mamba2_130m``'s smoke model: a bf16 tree (float32 ``A_log``, ``D``,
  ``dt_bias``) takes a train step with every gradient finite and each
  leaf kept in its type, and its float32 loss and gradients equal the
  reference's.

The 6-round trainer runs under every optimizer and protocol kind are in
tests/test_torch_train_rounds.py.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro import checkpoint as jckpt
from repro.configs import get as jget
from repro.core import protocol as jproto
from repro.models import build as jbuild

from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import get as tget
from repro_torch.core import protocol as tproto
from repro_torch.launch import train as ttrain
from repro_torch.models import build as tbuild
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig
from repro_torch.tree import leaves, tree_map

ARCH = "qwen2_5_3b"


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


def _close(got, want, label):
    gl = jax.tree.leaves(convert.to_numpy(got))
    wl = jax.tree.leaves(convert.to_numpy(want)) if not isinstance(
        want, (np.ndarray, jax.Array)) else [want]
    assert len(gl) == len(wl), (label, len(gl), len(wl))
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w, np.float32),
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=label)


def _batch(vocab, m, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (m, B, S + 1))
    jb = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
          "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks[..., :-1]),
          "labels": torch.as_tensor(toks[..., 1:])}
    return jb, tb


def test_lm_loss_and_gradients_match_reference():
    jc, tc = _cfgs()
    jp = _perturb(jbuild(jc).init(jax.random.PRNGKey(0)),
                  np.random.default_rng(1))
    tp = convert.lm_params(jp, tc, "cpu")
    japi, tapi = jbuild(jc), tbuild(tc)
    jvg = jax.jit(jax.value_and_grad(japi.loss))
    jb, tb = _batch(jc.vocab, 2)
    for i in range(2):
        jbi = {k: v[i] for k, v in jb.items()}
        tbi = {k: v[i] for k, v in tb.items()}
        jloss, jgrads = jvg(jp, jbi)
        flat = [x.requires_grad_(True) for x in leaves(tp)]
        tloss = tapi.loss(tp, tbi)
        tgrads = torch.autograd.grad(tloss, flat)
        for x in flat:
            x.requires_grad_(False)
        _close(tloss, np.asarray(jloss), f"loss {i}")
        want = leaves(convert.lm_params(jgrads, tc, "cpu"))
        assert len(want) == len(tgrads)
        for n, (g, w) in enumerate(zip(tgrads, want)):
            _close(g, w.numpy(), f"learner {i} gradient leaf {n}")


def test_embedding_backward_is_the_scatter_sum():
    """The one-hot backward of the embedding equals index_add's sums."""
    _, tc = _cfgs()
    table = torch.randn(tc.padded_vocab, 8, generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor([[3, 7, 3, 3], [0, 7, 511, 3]])
    g = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(1))
    t = table.clone().requires_grad_(True)
    from repro_torch.models.layers import embed
    out = embed({"table": t}, tokens)
    assert torch.equal(out, table[tokens])
    (got,) = torch.autograd.grad(out, t, g)
    want = torch.zeros_like(table).index_add_(0, tokens.reshape(-1),
                                              g.reshape(-1, 8))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Ports of tests/test_models_smoke.py's train-step tests (dense family)
# ---------------------------------------------------------------------------


def test_smoke_one_protocol_train_step():
    _, cfg = _cfgs()
    m = 2
    pcfg = tproto.ProtocolConfig(kind="dynamic", delta=1e6)
    opt_cfg = OptimizerConfig(kind="sgd", lr=0.01)
    state = ttrain.init_train_state(0, cfg, m, opt_cfg, device="cpu")
    step = ttrain.make_train_step(cfg, pcfg, opt_cfg)
    _, batch = _batch(cfg.vocab, m)
    new_state, loss = step(state, batch)
    assert not bool(torch.isnan(loss))
    assert int(new_state.step) == 1
    assert int(new_state.pstate.syncs) == 0
    diff = sum(float(torch.sum(torch.abs(a.float() - b.float())))
               for a, b in zip(leaves(new_state.params), leaves(state.params)))
    assert diff > 0.0


def test_smoke_train_step_loss_decreases():
    _, cfg = _cfgs()
    m = 2
    pcfg = tproto.ProtocolConfig(kind="continuous")
    opt_cfg = OptimizerConfig(kind="adamw", lr=3e-3)
    state = ttrain.init_train_state(0, cfg, m, opt_cfg, device="cpu")
    step = ttrain.make_train_step(cfg, pcfg, opt_cfg)
    _, batch = _batch(cfg.vocab, m, seed=1)
    losses = []
    for _ in range(8):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_trainer_defaults_to_the_card_and_raises_without_it():
    _, tc = _cfgs()
    if torch.cuda.is_available():
        state = ttrain.init_train_state(0, tc, 2, OptimizerConfig())
        assert leaves(state.params)[0].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.init_train_state(0, tc, 2, OptimizerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--steps", "1"])


def test_moe_and_encdec_families_train():
    """The trainer builds the MoE family and the encoder-decoder (m 2 from a
    seed) and takes a round with a finite loss, a MoE's carrying its aux
    loss, an encoder-decoder's batch holding ``frames``.  Only a name the
    registry does not know raises."""
    _, tc = _cfgs()
    opt_cfg = OptimizerConfig()
    for kw in (dict(arch_type="moe", n_experts=4, top_k=2, expert_ff=64),
               dict(encoder_layers=2, n_audio_frames=8)):
        cfg = tc.with_(**kw)
        state = ttrain.init_train_state(0, cfg, 2, opt_cfg, device="cpu")
        step = ttrain.make_train_step(cfg, tproto.ProtocolConfig(
            kind="periodic", period=1), opt_cfg)
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (2, 1, 7))
        batch = {"tokens": torch.as_tensor(toks[..., :-1]).long(),
                 "labels": torch.as_tensor(toks[..., 1:]).long()}
        if cfg.is_encdec:
            batch["frames"] = torch.as_tensor(rng.normal(
                size=(2, 1, 8, cfg.d_model)).astype(np.float32))
        state, loss = step(state, batch)
        assert np.isfinite(float(loss)) and int(state.pstate.syncs) == 1
        one = tree_map(lambda x: x[0], state.params)
        single = {k: v[0] for k, v in batch.items()}
        assert np.isfinite(float(tbuild(cfg).loss(one, single)))
        if cfg.arch_type == "moe":
            _, aux = ttransformer.forward_lm(one, cfg, single["tokens"])
            assert float(aux) > 0
    with pytest.raises(KeyError, match="unknown architecture"):
        tget("no_such_arch")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


class Carry(NamedTuple):
    weights: dict
    step: object
    flags: object


def _np_carry(seed):
    rng = np.random.default_rng(seed)
    return Carry(
        weights={"emb": rng.normal(size=(5, 3)).astype(np.float32),
                 "b": rng.normal(size=(4,)).astype(np.float32),
                 "layers": [rng.normal(size=(2, 2)).astype(np.float32)]},
        step=np.int32(seed + 7),
        flags=rng.random(3) < 0.5)


def _jcarry(c):
    w = c.weights
    return Carry(weights={"emb": jnp.asarray(w["emb"], jnp.bfloat16),
                          "b": jnp.asarray(w["b"]),
                          "layers": [jnp.asarray(w["layers"][0])]},
                 step=jnp.asarray(c.step), flags=jnp.asarray(c.flags))


def _tcarry(c):
    w = c.weights
    return Carry(weights={"emb": torch.as_tensor(w["emb"]).to(torch.bfloat16),
                          "b": torch.as_tensor(w["b"]),
                          "layers": [torch.as_tensor(w["layers"][0])]},
                 step=torch.as_tensor(c.step), flags=torch.as_tensor(c.flags))


def _bits(x):
    if torch.is_tensor(x):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy()).tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


def test_checkpoints_cross_between_the_packages(tmp_path):
    jtree, ttree = _jcarry(_np_carry(0)), _tcarry(_np_carry(1))
    # JAX writes, the port reads (into a like of other values)
    jckpt.save(str(tmp_path / "j.ckpt"), jtree)
    got = tckpt.restore(str(tmp_path / "j.ckpt"), ttree)
    assert type(got) is Carry and got.weights["emb"].dtype == torch.bfloat16
    for g, w in zip(leaves(got), jax.tree.leaves(jtree)):
        assert _bits(g) == _bits(w)
    # the port writes, JAX reads
    tckpt.save(str(tmp_path / "t.ckpt"), ttree)
    back = jckpt.restore(str(tmp_path / "t.ckpt"), jtree)
    assert back.weights["emb"].dtype == jnp.bfloat16
    for g, w in zip(jax.tree.leaves(back), leaves(ttree)):
        assert _bits(g) == _bits(w)


def test_protocol_state_crosses_from_the_reference(tmp_path):
    one = {"w": jnp.asarray(np.arange(6, dtype=np.float32)),
           "b": jnp.asarray(np.float32(2.5))}
    jstate = jproto.init_state(one, 3)
    jstate = jstate._replace(syncs=jnp.asarray(4, jnp.int32),
                             bytes_sent=jnp.asarray(123.0, jnp.float32))
    jckpt.save(str(tmp_path / "p.ckpt"), jstate)
    like = tproto.init_state({"w": torch.zeros(6), "b": torch.zeros(())}, 3)
    got = tckpt.restore(str(tmp_path / "p.ckpt"), like)
    assert isinstance(got, tproto.ProtocolState)
    assert int(got.syncs) == 4 and int(got.bytes_sent) == 123
    assert got.step.dtype == torch.int32
    assert torch.equal(got.reference["w"][2], torch.arange(6.0))
    conv = convert.protocol_state(jstate, "cpu")
    for g, w in zip(leaves(got), leaves(conv)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_round_trips_bitwise(tmp_path, dtype):
    _, tc = _cfgs(dtype=dtype)
    opt_cfg = OptimizerConfig(kind="sgd", lr=0.05, momentum=0.9)
    state = ttrain.init_train_state(0, tc, 2, opt_cfg, device="cpu")
    step = ttrain.make_train_step(tc, tproto.ProtocolConfig(kind="periodic",
                                                            period=2), opt_cfg)
    _, batch = _batch(tc.vocab, 2)
    state, _ = step(state, batch)
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    path = tckpt.save_step(d, 1, state)
    assert tckpt.latest_step(d) == path and path.endswith("step_00000001.ckpt")
    like = ttrain.init_train_state(1, tc, 2, opt_cfg, device="cpu")
    got = tckpt.restore(path, like)
    assert type(got) is ttrain.TrainState
    assert type(got.pstate) is tproto.ProtocolState
    for g, w in zip(leaves(got), leaves(state)):
        assert g.dtype == w.dtype and _bits(g) == _bits(w.contiguous())


def test_restore_refuses_a_mismatch(tmp_path):
    ttree = _tcarry(_np_carry(0))
    tckpt.save(str(tmp_path / "t.ckpt"), ttree)
    wrong = ttree._replace(weights=dict(ttree.weights,
                                        b=torch.zeros(5)))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path / "t.ckpt"), wrong)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(str(tmp_path / "t.ckpt"), ttree.weights)


def test_train_cli_on_the_cpu(capsys):
    ttrain.main(["--steps", "2", "--learners", "2", "--batch", "1",
                 "--seq", "8", "--protocol", "periodic", "--period", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step    0 loss=") and "syncs=  0" in out[0]
    assert "syncs=  1" in out[1]
    assert out[-1].endswith("1/2 rounds synchronized")


def test_train_cli_defaults_to_mamba2(monkeypatch, capsys):
    import repro_torch.configs as tconfigs

    asked = []

    def get(name):
        asked.append(name)
        return tget(name)

    monkeypatch.setattr(tconfigs, "get", get)
    ttrain.main(["--steps", "1", "--learners", "2", "--batch", "1",
                 "--seq", "8", "--device", "cpu"])
    assert asked == ["mamba2_130m"]
    assert capsys.readouterr().out.splitlines()[-1].endswith(
        "1/1 rounds synchronized")


def test_ssm_loss_and_gradients_match_reference():
    jc, tc = jget("mamba2_130m").smoke(), tget("mamba2_130m").smoke()
    jp = _perturb(jbuild(jc).init(jax.random.PRNGKey(0)),
                  np.random.default_rng(1))
    tp = convert.lm_params(jp, tc, "cpu")
    jb, tb = _batch(jc.vocab, 1, S=21)
    jb, tb = ({k: v[0] for k, v in b.items()} for b in (jb, tb))
    jloss, jgrads = jax.jit(jax.value_and_grad(jbuild(jc).loss))(jp, jb)
    flat = [x.requires_grad_(True) for x in leaves(tp)]
    tloss = tbuild(tc).loss(tp, tb)
    tgrads = torch.autograd.grad(tloss, flat)
    _close(tloss, np.asarray(jloss), "loss")
    want = leaves(convert.lm_params(jgrads, tc, "cpu"))
    assert len(want) == len(tgrads)
    for n, (g, w) in enumerate(zip(tgrads, want)):
        _close(g, w.numpy(), f"gradient leaf {n}")


def test_ssm_bf16_train_step_keeps_each_leaf_type():
    tc = tget("mamba2_130m").smoke().with_(dtype="bfloat16")
    opt_cfg = OptimizerConfig(kind="sgd", lr=0.05, grad_clip=1.0)
    state = ttrain.init_train_state(0, tc, 2, opt_cfg, device="cpu")
    step = ttrain.make_train_step(
        tc, tproto.ProtocolConfig(kind="periodic", period=1), opt_cfg)
    _, batch = _batch(tc.vocab, 2)
    new, loss = step(state, batch)
    assert torch.isfinite(loss)
    for a, b in zip(leaves(new.params), leaves(state.params)):
        assert a.dtype == b.dtype and bool(torch.isfinite(a.float()).all())
    f32 = [x for x in leaves(new.params) if x.dtype == torch.float32]
    assert len(f32) == 3 * tc.n_layers       # A_log, D, dt_bias a layer
    # a sync charges each leaf's own bytes: 2 m |model|
    one = tree_map(lambda x: x[0], state.params)
    charge = np.float32(2 * 2 * tproto.model_bytes(one))
    assert new.pstate.bytes_sent.numpy().tobytes() == charge.tobytes()
