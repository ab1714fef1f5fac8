"""The port's RG-LRU block (``models/rglru.py``) against the JAX
package's, on the CPU.

- ``_scan`` against ``jax.lax.associative_scan``: bitwise the eager
  call, whose every operation rounds once (S 37; odd lengths take the
  recursion's other branch).  Under ``jax.jit`` XLA contracts each
  ``a2 * b1 + b2`` into a fused multiply-add; the port's recursion with
  that one change (the test's ``_scan_fma``) is bitwise the jitted
  scan at S 1, 2, 3, 5, 12, 37 and 2,304, so the combination tree is
  the reference's and only the rounding of the fused products differs
  (ROADMAP.md, Faults).
- ``rglru_forward`` at B 2, S 12 and S 37, with and without a carried
  state, and ``rglru_decode`` steps, on the reference's parameters
  with seeded noise on the biases (zeros at init); ``causal_conv1d``'s
  carried context and buffer; a forward with the exact-erf GELU misses
  the reference by far more than the port's forward does (the tanh
  approximation is ``jax.nn.gelu``'s default).
- The reference's own contracts of tests/test_rglru.py on the port:
  the scan against its own step loop, a state handed over mid-sequence,
  decays in (0, 1).
- Gradients: through ``_scan`` finite and within 1e-5 of a float64
  step loop's at S 2,304; through the block against ``jax.grad``
  (``Lambda`` included) within the parity pair.
- ``rglru_init``'s leaves: shapes and types as the reference's at the
  smoke and full widths (``Lambda`` float32 in a bf16 tree), and its
  decays in [0.9, 0.999] at r = 1; ``expand_left`` as the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.configs import get as jget
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro.models.config import ModelConfig as JConfig

from repro_torch.configs import get as tget
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trg
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.tree import leaves

# tests/test_rglru.py's block
KW = dict(arch_type="hybrid", d_model=16, lru_width=16, conv_width=4,
          vocab=32, layer_pattern=("rglru",), n_layers=1, dtype="float32")
JC, TC = JConfig(**KW), TConfig(**KW)
NOISY = ("b",)


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _close(got, want, label, rtol=PARITY_RTOL, atol=PARITY_ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got)), label
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def _scan_fma(a, b):
    """The port's recursion with each a2 * b1 + b2 rounded once (the
    product is exact in float64): what XLA's contraction computes."""
    n = a.shape[1]
    if n < 2:
        return b

    def fma(x, y, z):
        return (x.double() * y.double() + z.double()).float()

    a2 = a[:, 1::2]
    odd = _scan_fma(a[:, 0:-1:2] * a2, fma(a2, b[:, 0:-1:2], b[:, 1::2]))
    left = odd[:, :-1] if n % 2 == 0 else odd
    even = fma(a[:, 2::2], left, b[:, 2::2])
    return trg._interleave(torch.cat([b[:, :1], even], dim=1), odd)


def test_scan_is_the_reference_associative_scan():
    """Eager at S 37 (each eager operation compiles on its own, seconds
    a call); jitted at S 1, 2, 3, 5 and three larger."""
    jitted = jax.jit(lambda a, b: jax.lax.associative_scan(
        _combine, (a, b), axis=1))
    for S in (1, 2, 3, 5, 12, 37, 2304):
        rng = np.random.default_rng(S)
        a = rng.uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
        b = rng.normal(size=(2, S, 8)).astype(np.float32)
        got = trg._scan(_t(a), _t(b)).numpy()
        if S == 37:
            _, want = jax.lax.associative_scan(
                _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
            assert got.tobytes() == np.asarray(want).tobytes(), S
        _, want = jitted(a, b)
        fused = _scan_fma(_t(a), _t(b)).numpy()
        assert fused.tobytes() == np.asarray(want).tobytes(), S
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


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


_BLOCK = {}


def _block(seed=0):
    """The reference's block parameters with seeded noise on the
    biases, and the same numbers as the port's tree."""
    if seed not in _BLOCK:
        jp = jax.jit(lambda k: jrg.rglru_init(k, JC, jnp.float32))(
            jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)

        def noisy(tree):
            if isinstance(tree, dict):
                return {k: (jnp.asarray(np.asarray(v) + rng.normal(
                    scale=0.1, size=v.shape).astype(np.float32))
                    if k in NOISY else noisy(v)) for k, v in tree.items()}
            return tree

        jp = noisy(jp)
        _BLOCK[seed] = (jp, jax.tree.map(_t, jp))
    return _BLOCK[seed]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [12, 37])
def test_forward_matches_reference(S, carried):
    jp, tp = _block()
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 16)).astype(np.float32)
    jst = tst = None
    if carried:
        h0 = rng.normal(size=(2, 16)).astype(np.float32)
        buf = rng.normal(size=(2, 3, 16)).astype(np.float32)
        jst = jrg.LRUState(h=jnp.asarray(h0), conv_buf=jnp.asarray(buf))
        tst = trg.LRUState(h=_t(h0), conv_buf=_t(buf))
    jy, jnew = jax.jit(lambda p, x, st: jrg.rglru_forward(JC, p, x, st))(
        jp, jnp.asarray(x), jst)
    ty, tnew = trg.rglru_forward(TC, tp, _t(x), tst)
    _close(ty, jy, f"y S={S}")
    _close(tnew.h, jnew.h, "h")
    assert tnew.h.dtype == torch.float32
    _close(tnew.conv_buf, jnew.conv_buf, "conv_buf")
    # and tighter than the exact-erf GELU gets
    err = np.max(np.abs(ty.numpy() - np.asarray(jy)))
    gelu = torch.nn.functional.gelu
    try:
        torch.nn.functional.gelu = lambda v, approximate="none": gelu(v)
        erf = trg.rglru_forward(TC, tp, _t(x), tst)[0].numpy()
    finally:
        torch.nn.functional.gelu = gelu
    assert np.max(np.abs(erf - np.asarray(jy))) > 20 * max(err, 1e-7)


def test_decode_matches_reference():
    """Six steps from a carried state, each output and state against
    the reference's step."""
    jp, tp = _block(1)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 16)).astype(np.float32)
    jst = jrg.LRUState(h=jnp.asarray(rng.normal(size=(2, 16)), jnp.float32),
                       conv_buf=jnp.asarray(rng.normal(size=(2, 3, 16)),
                                            jnp.float32))
    tst = trg.LRUState(h=_t(jst.h), conv_buf=_t(jst.conv_buf))
    step = jax.jit(lambda p, x, st: jrg.rglru_decode(JC, p, x, st))
    for t in range(6):
        jy, jst = step(jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = trg.rglru_decode(TC, tp, _t(x[:, t:t + 1]), tst)
        assert ty.shape == (2, 1, 16)
        _close(ty, jy, f"decode {t}")
        _close(tst.h, jst.h, f"decode h {t}")
        _close(tst.conv_buf, jst.conv_buf, f"decode buf {t}")


def test_forward_matches_own_step_loop_and_state_handoff():
    """tests/test_rglru.py's contracts on the port: the scan against
    the decode loop (1e-4 / 1e-5, as there), a forward continued from
    a mid-sequence state, decays in (0, 1)."""
    jp, tp = _block(2)
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(2, 12, 16)))
    y_scan, st_scan = trg.rglru_forward(TC, tp, x)
    st = trg.init_lru_state(TC, 2, torch.float32)
    outs = []
    for t in range(12):
        y_t, st = trg.rglru_decode(TC, tp, x[:, t:t + 1], st)
        outs.append(y_t[:, 0])
    np.testing.assert_allclose(y_scan.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st_scan.h.numpy(), st.h.numpy(), rtol=1e-4,
                               atol=1e-5)
    y_a, st = trg.rglru_forward(TC, tp, x[:, :5])
    y_b, _ = trg.rglru_forward(TC, tp, x[:, 5:], st)
    np.testing.assert_allclose(y_b.numpy(), y_scan[:, 5:].numpy(),
                               rtol=1e-4, atol=1e-5)
    a, _ = trg._gates(tp, _t(rng.normal(size=(4, 16))))
    assert 0.0 < float(a.min()) and float(a.max()) < 1.0


def test_scan_gradients_match_a_float64_loop():
    """At the trainer's length (2,304 tokens), W 8: the scan's
    gradients with respect to a and b are finite and within 1e-5 (of
    the largest) of a float64 step loop's."""
    S = 2304
    rng = np.random.default_rng(5)
    a = rng.uniform(0.9, 1.0, (1, S, 8)).astype(np.float32)
    b = rng.normal(size=(1, S, 8)).astype(np.float32)
    r = rng.normal(size=(1, S, 8)).astype(np.float32)
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    loss = (trg._scan(ta, tb) * _t(r)).sum()
    ga, gb = torch.autograd.grad(loss, (ta, tb))
    # float64 loop: h_t = a_t h_{t-1} + b_t; its adjoint runs backwards
    a64, b64, r64 = (torch.as_tensor(v, dtype=torch.float64)
                     for v in (a, b, r))
    h = torch.zeros(1, 8, dtype=torch.float64)
    hs = []
    for t in range(S):
        h = a64[:, t] * h + b64[:, t]
        hs.append(h)
    gh = torch.zeros(1, 8, dtype=torch.float64)
    wa, wb = torch.zeros_like(a64), torch.zeros_like(b64)
    for t in reversed(range(S)):
        gh = gh + r64[:, t]
        wb[:, t] = gh
        wa[:, t] = gh * (hs[t - 1] if t else 0.0)
        gh = gh * a64[:, t]
    for got, want, name in ((ga, wa, "a"), (gb, wb, "b")):
        assert torch.isfinite(got).all(), name
        scale = float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= 1e-5 * scale, name


def test_block_gradients_match_reference():
    jp, tp = _block(3)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 37, 16)).astype(np.float32)
    r = rng.normal(size=(2, 37, 16)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jrg.rglru_forward(JC, p, x)[0] * r)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    flat = [v.requires_grad_(True) for v in leaves(tp)]
    tx = _t(x).requires_grad_(True)
    loss = torch.sum(trg.rglru_forward(TC, tp, tx)[0] * _t(r))
    grads = torch.autograd.grad(loss, flat + [tx])
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]] + ["x"]
    assert any("Lambda" in p for p in paths)
    for g, w, name in zip(grads, jax.tree.leaves(jg) + [jgx], paths):
        scale = float(np.max(np.abs(np.asarray(w)))) or 1.0
        _close(g / scale, np.asarray(w) / scale, f"grad {name}")
    for v in flat:
        v.requires_grad_(False)


def test_init_leaves_match_the_reference():
    gen = torch.Generator().manual_seed(0)
    for jc, tc in ((jget("recurrentgemma_9b").smoke(),
                    tget("recurrentgemma_9b").smoke()),
                   (jget("recurrentgemma_9b"), tget("recurrentgemma_9b"))):
        want = jax.eval_shape(lambda k: jrg.rglru_init(k, jc, jnp.bfloat16),
                              jax.random.PRNGKey(0))
        if tc.d_model <= 256:
            got = trg.rglru_init(gen, tc, torch.bfloat16)
            lam = got["Lambda"]
            a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
            assert 0.9 - 1e-6 <= float(a.min()) and \
                float(a.max()) <= 0.999 + 1e-6
        else:
            from repro_torch.launch.specs import _MetaGenerator
            got = trg.rglru_init(_MetaGenerator(), tc, torch.bfloat16)
        paths = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(paths) == len(leaves(got))
        for (path, j), t in zip(paths, leaves(got)):
            assert tuple(t.shape) == j.shape, path
            assert str(t.dtype)[6:] == str(j.dtype), path
        assert got["Lambda"].dtype == torch.float32
    v = np.arange(6, dtype=np.float32)
    assert tlayers.expand_left(_t(v), 3).shape == \
        jlayers.expand_left(jnp.asarray(v), 3).shape == (1, 1, 6)
