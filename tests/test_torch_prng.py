"""The port's seeded draws (``repro_torch.prng``, ``repro_torch.xla_math``)
against ``jax.random`` and XLA's CPU math, on the CPU.

Every comparison is bitwise (float32 or bf16 bits, or uint32 words):
keys, ``split`` and ``fold_in``; the random bits, ``uniform`` and
``normal`` at five shapes and, for ``normal``, at 2e5 values; the bf16
cast after a scale; ``log1p`` and ``erf_inv`` on the values ``normal``
gives them; ``fma`` against the exact sum rounded once.  Then what the
draws are for: ``RFFSpec(seed)`` without arrays equal to
``repro.core.rff.rff_params``, and for each of the 11 architectures of
``configs`` at its smoke widths (2 or 3 layers, d_model 256) the port's
``build(cfg).init(0)`` against the reference's
``init(jax.random.PRNGKey(0))`` leaf for leaf (bitwise, but RG-LRU's
``Lambda``, a log of an expm1 of a log of the draw, within the parity
pair of tests/conftest.py), and ``init_train_state(0, ...)`` against
the reference's (four architectures).  ``paper_kernel`` has no
network; its case is the RFF draw at its learner's dim and gamma.  A
``torch.Generator`` still draws PyTorch's stream, in call order: for one
architecture of each family, every drawn leaf bitwise a plain replay of
that stream (``torch.randn`` / ``torch.rand`` in the initializers' call
order, each with its scale as PyTorch applied it).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.core import rff as jrff
from repro.launch import train as jtrain
from repro.models import build as jbuild
from repro.optim import OptimizerConfig as JOpt

from repro_torch import convert, prng, xla_math
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get as tget
from repro_torch.core import rff as trff
from repro_torch.launch import train as ttrain
from repro_torch.models.encdec import MAX_DEC_POS
from repro_torch.models.model import build as tbuild
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim import OptimizerConfig as TOpt
from repro_torch.tree import leaves

from conftest import PARITY_ATOL, PARITY_RTOL

SHAPES = [(1,), (7,), (2048,), (2048, 18), (3, 5, 7)]
RANGES = [(0.0, 1.0), (0.0, 2.0 * math.pi), (0.9, 0.999), (-3.0, 2.5)]
TRAIN_ARCHS = ["mamba2_130m", "recurrentgemma_9b", "olmoe_1b_7b",
               "whisper_large_v3"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one intra-op thread for the module (as
    tests/test_torch_examples.py): the draws are short elementwise ops,
    whose thread team costs more than it saves beside JAX's threads and
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _bits32(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32).tobytes()


def _key(seed=0):
    """A key a few levels down the tree, both sides."""
    j = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed))[1], 7)
    t = prng.fold_in(prng.split(prng.PRNGKey(seed))[1], 7)
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 3, 2**31, 2**32 + 5, -1])
def test_prng_key(seed):
    assert (_words(jax.random.PRNGKey(seed))
            == prng.PRNGKey(seed).numpy()).all()


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", [0, 3])
def test_split(seed, num):
    want = _words(jax.random.split(jax.random.PRNGKey(seed), num))
    got = prng.split(prng.PRNGKey(seed), num).numpy()
    assert got.shape == (num, 2) and (got == want).all()


@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 3])
def test_fold_in(data):
    j, t = _key(3)
    assert (_words(jax.random.fold_in(j, data))
            == prng.fold_in(t, data).numpy()).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(shape):
    j, t = _key()
    got = prng.random_bits(t, shape).numpy()
    assert got.shape == shape
    assert (got == _words(jax.random.bits(j, shape))).all()


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape, lo, hi):
    j, t = _key()
    want = jax.random.uniform(j, shape, minval=lo, maxval=hi)
    got = prng.uniform(t, shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _bits32(got.numpy()) == _bits32(want)


@pytest.mark.parametrize("shape", SHAPES + [(200_000,)])
def test_normal(shape):
    j, t = _key()
    got = prng.normal(t, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _bits32(got.numpy()) == _bits32(jax.random.normal(j, shape))


@pytest.mark.parametrize("d_in", [18, 96, 1000])
def test_bf16_after_scale(d_in):
    """``dense_init``'s leaf: the draw times ``1 / jnp.sqrt(d_in)``, cast
    to bf16."""
    j, t = _key(1)
    want = (jax.random.normal(j, (64, d_in)) * (1.0 / jnp.sqrt(d_in))
            ).astype(jnp.bfloat16)
    s = float(np.float32(1.0) / np.sqrt(np.float32(d_in)))
    got = (prng.normal(t, (64, d_in)) * s).to(torch.bfloat16)
    assert got.view(torch.int16).numpy().tobytes() \
        == np.asarray(want).view(np.int16).tobytes()


def test_any_range_of_flat_indices_draws_alone(monkeypatch):
    """An element depends on the key and its flat index only: the
    ``*_at`` draws of a slice equal that slice of the whole draw, and
    the whole draw does not depend on its chunk size."""
    _, t = _key()
    whole = prng.normal(t, (300, 7)).reshape(-1)
    index = torch.arange(1234, 1900)
    assert torch.equal(prng.normal_at(t, index), whole[1234:1900])
    u = prng.uniform(t, (300, 7), 0.9, 0.999).reshape(-1)
    assert torch.equal(prng.uniform_at(t, index, 0.9, 0.999), u[1234:1900])
    assert torch.equal(prng.bits_at(t, index),
                       prng.random_bits(t, (300, 7)).reshape(-1)[1234:1900])
    monkeypatch.setattr(prng, "CHUNK", 97)
    assert torch.equal(prng.normal(t, (300, 7)).reshape(-1), whole)


def test_xla_math_on_the_draws_values():
    """``log1p`` on -u^2 and ``erf_inv`` on u, u the values ``normal``
    takes (2e5 of them, both branches of each), and ``sqrt`` on
    ``erf_inv``'s tail: bitwise XLA's."""
    j, _ = _key(3)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = np.asarray(jax.random.uniform(j, (200_000,), minval=lo, maxval=1.0))
    x = (u * -u).astype(np.float32)
    assert _bits32(xla_math.log1p(torch.from_numpy(x)).numpy()) \
        == _bits32(jnp.log1p(x))
    assert _bits32(xla_math.erf_inv(torch.from_numpy(u.copy())).numpy()) \
        == _bits32(jax.lax.erf_inv(u))
    w = np.linspace(5.0, 90.0, 100_003, dtype=np.float32)
    assert _bits32(xla_math.sqrt(torch.from_numpy(w)).numpy()) \
        == _bits32(jnp.sqrt(w))


def test_fma_rounds_once():
    """``fma`` equals the exact a * b + c rounded to float32: random
    operands, cancelling ones, and sums that land halfway between two
    float32 values in float64 (where a float64 sum rounded again errs)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(100_000).astype(np.float32)
    b = rng.standard_normal(100_000).astype(np.float32)
    near = -(a.astype(np.float64) * b) * (1 + rng.standard_normal(100_000)
                                          * 1e-6)
    for c in (rng.standard_normal(100_000).astype(np.float32),
              near.astype(np.float32)):
        want = (a.astype(np.longdouble) * b + c).astype(np.float32)
        got = xla_math.fma(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
        assert got.tobytes() == want.tobytes()
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24, a float32 midpoint; a tiny c
    # decides the rounding, which a float64 sum loses
    h = np.float32(1 + 2**-12)
    cs = np.float32([2**-60, -2**-60, 0.0])
    got = xla_math.fma(torch.full((3,), float(h)), float(h),
                       torch.from_numpy(cs)).numpy()
    up, down = np.float32(1 + 2**-11 + 2**-23), np.float32(1 + 2**-11)
    assert got.tolist() == [up, down, down]
    assert np.float32(np.float64(h) * np.float64(h) + 2**-60) == down


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("D,d", [(2048, 18), (64, 8)])
def test_rff_spec_draws_the_reference_features(seed, D, d):
    for gamma in (1.0, 0.3):
        W, b = jrff.rff_params(jrff.RFFSpec(dim=d, num_features=D,
                                            gamma=gamma, seed=seed))
        tW, tb = trff.rff_params(trff.RFFSpec(dim=d, num_features=D,
                                              gamma=gamma, seed=seed))
        assert _bits32(tW.numpy()) == _bits32(W)
        assert _bits32(tb.numpy()) == _bits32(b)


def _cfgs(arch, dtype):
    return (jget(arch).smoke().with_(dtype=dtype),
            tget(arch).smoke().with_(dtype=dtype))


def _assert_leaves_equal(got, want):
    """Port tree ``got`` against the reference's tree carried across
    (``want``), leaf for leaf: bitwise, but RG-LRU's ``Lambda``."""
    def walk(g, w, path):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w), path
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, (list, tuple)):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, path + (i,))
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if path and path[-1] == "Lambda":
                np.testing.assert_allclose(g.numpy(), w.numpy(),
                                           rtol=PARITY_RTOL,
                                           atol=PARITY_ATOL,
                                           err_msg=str(path))
            else:
                assert torch.equal(g.view(torch.int16) if g.dtype
                                   == torch.bfloat16 else g,
                                   w.view(torch.int16) if w.dtype
                                   == torch.bfloat16 else w), path
    walk(got, want, ())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_draws_the_reference_model(arch):
    """float32 leaves here; ``init_train_state``'s case below draws the
    bf16 ones."""
    if arch == "paper_kernel":
        # no network: its seeded draw is the RFF map of its kernel
        lc = tget(arch).learner
        for D in (64, 2048):
            W, b = jrff.rff_params(jrff.RFFSpec(
                dim=lc.dim, num_features=D, gamma=lc.kernel.gamma))
            tW, tb = trff.rff_params(trff.RFFSpec(
                dim=lc.dim, num_features=D, gamma=lc.kernel.gamma))
            assert _bits32(tW.numpy()) == _bits32(W)
            assert _bits32(tb.numpy()) == _bits32(b)
        return
    jc, tc = _cfgs(arch, "float32")
    want = convert.lm_params(jbuild(jc).init(jax.random.PRNGKey(0)), tc,
                             "cpu")
    got = tbuild(tc).init(0, device="cpu")
    _assert_leaves_equal(got, want)


def test_init_takes_a_key_for_its_seed():
    tc = tget("mamba2_130m").smoke()
    seed = tbuild(tc).init(3, device="cpu")
    key = tbuild(tc).init(prng.PRNGKey(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(key), leaves(seed)))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_init_train_state_is_the_reference_clis(arch):
    """``init_train_state(0, ...)`` is the reference CLI's
    ``init_train_state(jax.random.PRNGKey(0), ...)``: parameters,
    optimizer state, protocol state and step, leaf for leaf, in bf16,
    for the CLI's default architecture and one of each family whose
    tree has float32 leaves or an encoder (``init``'s case above draws
    every architecture)."""
    jc, tc = _cfgs(arch, "bfloat16")
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jc, 2,
                                     JOpt(kind="adamw", lr=1e-3))
    want = convert.train_state(jstate, tc, "cpu")
    got = ttrain.init_train_state(0, tc, 2, TOpt(kind="adamw", lr=1e-3),
                                  device="cpu")
    assert type(got) is type(want)
    for field in ("params", "opt", "pstate", "step"):
        _assert_leaves_equal(getattr(got, field), getattr(want, field))


def test_a_generator_draws_torch_in_call_order():
    """A ``torch.Generator`` keeps PyTorch's stream: the first leaf drawn
    (the embedding) is the generator's first ``randn`` times 0.02."""
    tc = tget("qwen2_5_3b").smoke()
    got = tbuild(tc).init(torch.Generator().manual_seed(0), device="cpu")
    want = torch.randn((tc.padded_vocab, tc.d_model),
                       generator=torch.Generator().manual_seed(0)) * 0.02
    assert torch.equal(got["embed"]["table"], want)


#: one architecture of each family: dense (an untied head), VLM, MLA,
#: MoE, SSM, hybrid, encoder-decoder
GENERATOR_ARCHS = ["granite_8b", "qwen2_vl_2b", "minicpm3_4b", "olmoe_1b_7b",
                   "mamba2_130m", "recurrentgemma_9b", "whisper_large_v3"]


def _generator_replay(cfg, gen):
    """{path: leaf} of every leaf a ``torch.Generator`` draws: one
    stream, in the order the initializers call it (an encoder-decoder's
    embedding, decoder positions, encoder blocks, decoder blocks, head;
    a decoder's embedding, head, then its layers in pattern order), each
    draw times its scale as a float64 Python number (or divided by one),
    then cast to the model's dtype."""
    dt, d, H = torch_dtype(cfg), cfg.d_model, cfg.n_heads
    out = {}

    def randn(path, shape, mul=None, div=None):
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        out[path] = (x * mul if div is None else x / div).to(dt)

    def dense(path, d_in, d_out):
        randn(path + ("w",), (d_in, d_out), mul=1.0 / math.sqrt(d_in))

    def conv(path, width, ch):
        randn(path + ("w",), (width, ch), div=math.sqrt(width))

    def mlp(path):
        dense(path + ("wi",), d, cfg.d_ff)
        if cfg.act == "silu_glu":
            dense(path + ("wg",), d, cfg.d_ff)
        dense(path + ("wo",), cfg.d_ff, d)

    def gqa(path):
        hd = cfg.hd
        for name, (i, o) in (("wq", (d, H * hd)),
                             ("wk", (d, cfg.n_kv_heads * hd)),
                             ("wv", (d, cfg.n_kv_heads * hd)),
                             ("wo", (H * hd, d))):
            dense(path + (name,), i, o)

    def mla(path):
        qk = cfg.mla_nope_dim + cfg.mla_rope_dim
        for name, (i, o) in (
                ("w_dq", (d, cfg.mla_q_lora)),
                ("w_uq", (cfg.mla_q_lora, H * qk)),
                ("w_dkv", (d, cfg.mla_kv_lora)),
                ("w_kr", (d, cfg.mla_rope_dim)),
                ("w_uk", (cfg.mla_kv_lora, H * cfg.mla_nope_dim)),
                ("w_uv", (cfg.mla_kv_lora, H * cfg.mla_v_dim)),
                ("wo", (H * cfg.mla_v_dim, d))):
            dense(path + (name,), i, o)

    def moe(path):
        E, ff = cfg.n_experts, cfg.expert_ff
        dense(path + ("router",), d, E)
        randn(path + ("wi",), (E, d, ff), div=math.sqrt(d))
        randn(path + ("wg",), (E, d, ff), div=math.sqrt(d))
        randn(path + ("wo",), (E, ff, d), div=math.sqrt(ff))

    def ssm(path):
        din, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        dense(path + ("in_proj",), d, 2 * din + 2 * GN + cfg.ssm_heads)
        conv(path + ("conv",), cfg.ssm_conv, din + 2 * GN)
        dense(path + ("out_proj",), din, d)

    def rglru(path):
        W = cfg.lru_dim
        dense(path + ("w_y",), d, W)
        dense(path + ("w_x",), d, W)
        conv(path + ("conv",), cfg.conv_width, W)
        dense(path + ("w_a",), W, W)
        dense(path + ("w_i",), W, W)
        u = torch.rand((W,), generator=gen, dtype=torch.float32) \
            * (0.999 - 0.9) + 0.9
        out[path + ("Lambda",)] = torch.log(torch.expm1(-torch.log(u) / 8.0))
        dense(path + ("w_o",), W, d)

    randn(("embed", "table"), (cfg.padded_vocab, d), mul=0.02)
    if cfg.encoder_layers:
        randn(("dec_pos", "table"), (MAX_DEC_POS, d), mul=0.01)
        for i in range(cfg.encoder_layers):
            gqa(("enc_blocks", i, "attn"))
            mlp(("enc_blocks", i, "mlp"))
        for i in range(cfg.n_layers):
            gqa(("dec_blocks", i, "self_attn"))
            gqa(("dec_blocks", i, "cross_attn"))
            mlp(("dec_blocks", i, "mlp"))
    if not cfg.tie_embeddings:
        dense(("lm_head",), d, cfg.padded_vocab)
    for i, kind in enumerate(() if cfg.encoder_layers else cfg.pattern):
        block = ("layers", i)
        if kind == "ssm":
            ssm(block + ("ssm",))
            continue
        if kind == "rglru":
            rglru(block + ("rglru",))
        else:
            (mla if cfg.attn_kind == "mla" else gqa)(block + ("attn",))
        if kind == "moe":
            moe(block + ("moe",))
        else:
            mlp(block + ("mlp",))
    return out


def _paths(tree, path=()):
    """{path: leaf} of a parameter tree."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k],
                                                      path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", GENERATOR_ARCHS)
def test_a_generator_draws_the_parents_stream(arch):
    """Every leaf a ``torch.Generator`` draws is the replay's, bitwise;
    the leaves that do not change with the generator's seed are the ones
    the replay does not draw; and the stream ends where the replay's
    does (no draw added or left out)."""
    tc = tget(arch).smoke()
    gen = torch.Generator().manual_seed(0)
    got = _paths(tbuild(tc).init(gen, device="cpu"))
    replay_gen = torch.Generator().manual_seed(0)
    want = _generator_replay(tc, replay_gen)
    other = _paths(tbuild(tc).init(torch.Generator().manual_seed(1),
                                   device="cpu"))
    assert {p for p in got if not torch.equal(got[p], other[p])} == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype and torch.equal(got[path], leaf), \
            path
    assert torch.equal(gen.get_state(), replay_gen.get_state())
