"""The port's ``flash_attention`` against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version
(``ref.flash_ref``); the reference's ``flash_attention`` runs its
Pallas kernel in interpret mode (``interpret=True``), at the flash
cases of tests/test_kernels_pallas.py: S in {128, 256, 384}, hd in
{64, 128}, causal and not, sliding windows of 32, 64 and 100, and the
bf16 case.  Then the model's ``_flash_sdpa`` (GQA heads folded, the
reference padding a ragged S to its block, the port masking it) at
S in {1, 17, 129}, and shapes the reference's kernel needs one block
for (ragged non-causal, S != L).

Tolerances: the JAX package's own, rtol = atol = 2e-5 in fp32 and
3e-2 in bf16 (tests/test_kernels_pallas.py).

The tensor-core redesign of the kernel (tools/flash_tc/flash_wgmma.cu)
runs both products on bf16 tensor cores and keeps float32 precision by
splitting into three bf16 parts (``ref.split_bf16``): the split's own
tests, and a plain emulation of that kernel's arithmetic (the six cross
terms of q.k and p.v, the online softmax over 64-key tiles) held
against the Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.kernels.flash import flash_attention as jflash
from repro.models import attention as jattn

from repro_torch.configs import get as tget
from repro_torch.kernels import flash, ops, ref
from repro_torch.models import attention as tattn

TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(rng, BH, S, hd, L=None, dtype=np.float32):
    L = S if L is None else L
    return (rng.normal(size=(BH, S, hd)).astype(dtype),
            rng.normal(size=(BH, L, hd)).astype(dtype),
            rng.normal(size=(BH, L, hd)).astype(dtype))


def _port(q, k, v, **kw):
    ops.reset_launch_counts()
    out = flash.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                **kw)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU call launched"
    return out


def _pallas(q, k, v, block_q, block_k, **kw):
    return np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             block_q=block_q, block_k=block_k, interpret=True,
                             **kw))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [128, 256, 384])
def test_flash_matches_pallas(S, hd, causal):
    q, k, v = _qkv(np.random.default_rng(S + hd), 3, S, hd)
    got = _port(q, k, v, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (3, S, hd)
    np.testing.assert_allclose(got.numpy(),
                               _pallas(q, k, v, 128, 128, causal=causal),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [32, 64, 100])
def test_flash_sliding_window_matches_pallas(window, causal):
    q, k, v = _qkv(np.random.default_rng(2), 2, 256, 64)
    got = _port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(
        got.numpy(), _pallas(q, k, v, 64, 64, causal=causal, window=window),
        rtol=TOL, atol=TOL)


def test_flash_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(rng, 2, 128, 64))
    want = np.asarray(jflash(q, k, v, block_q=64, block_k=64, interpret=True),
                      np.float32)
    # the same bf16 values on both sides: widen, then hand them over
    got = _port(*(torch.as_tensor(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("S,L,causal", [(129, 129, False), (64, 192, False),
                                        (192, 64, True), (100, 100, True)])
def test_flash_any_shape_matches_one_block_pallas(S, L, causal):
    """Ragged and rectangular shapes: the reference's kernel takes them
    in one block per axis, the port's without padding."""
    q, k, v = _qkv(np.random.default_rng(S * L), 2, S, 64, L=L)
    np.testing.assert_allclose(
        _port(q, k, v, causal=causal).numpy(),
        _pallas(q, k, v, S, L, causal=causal), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 17, 129])
def test_flash_sdpa_matches_reference(S):
    jc, tc = (get("qwen2_5_3b").smoke() for get in (jget, tget))
    assert tc.n_kv_heads < tc.n_heads
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, tc.n_heads, tc.hd)).astype(np.float32)
    k = rng.normal(size=(2, S, tc.n_kv_heads, tc.hd)).astype(np.float32)
    v = rng.normal(size=(2, S, tc.n_kv_heads, tc.hd)).astype(np.float32)
    want = np.asarray(jattn._flash_sdpa(jc, *(jnp.asarray(a) for a in
                                              (q, k, v)), True))
    ops.reset_launch_counts()
    got = tattn._flash_sdpa(tc, *(torch.as_tensor(a) for a in (q, k, v)),
                            True)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # and the flat-H plain path of the same model
    plain = tattn._sdpa(*(torch.as_tensor(a) for a in (q, k, v)),
                        tattn.causal_mask(S, S), tattn._inv_sqrt(tc.hd))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)


def test_flash_wrapper_refuses_what_it_cannot_take():
    q, k, v = (torch.as_tensor(a) for a in
               _qkv(np.random.default_rng(0), 2, 8, 64))
    with pytest.raises(ValueError, match="shapes"):
        flash.flash_attention(q, k[:, :, :32], v)
    with pytest.raises(ValueError, match="dtypes"):
        flash.flash_attention(q, k.double(), v)
    # the default scale is hd ** -0.5, as the reference's
    np.testing.assert_array_equal(
        flash.flash_attention(q, k, v).numpy(),
        ref.flash_ref(q, k, v, scale=64 ** -0.5).numpy())


def test_split_bf16_holds_float32_values():
    """Within 2^-24 relative wherever lo stays a normal number (|x| above
    2^-110; below it the float32 range itself cuts lo's bits)."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.normal(size=4096), rng.uniform(0.0, 1.0, size=4096),
        rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, size=4096),
    ]).astype(np.float32)
    x = torch.as_tensor(x[np.abs(x) >= 2.0 ** -110])
    assert x.numel() > 12000
    hi, mid, lo = ref.split_bf16(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    err = (total - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all()), \
        float((err / x.double().abs().clamp_min(1e-300)).max())
    # the parts fall off by a bf16 significand each
    assert bool((mid.double().abs() <= 2.0 ** -8 * hi.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -8 * mid.double().abs()).all())


def test_split_bf16_of_a_bf16_value_is_the_value():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=8192).astype(np.float32)) \
        .to(torch.bfloat16).float()
    hi, mid, lo = ref.split_bf16(x)
    assert torch.equal(hi.float(), x)
    assert not bool(mid.float().any()) and not bool(lo.float().any())


#: the cross terms above 2^-24 of a product of two three-part splits, in
#: the kernel's order, smallest first (tools/flash_tc/flash_wgmma.cu:
#: term_a, term_b)
TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def _split_matmul(a, b):
    """a @ b with both split into three bf16 parts and the six cross
    terms summed in float32, smallest first: what the kernel's MMAs
    compute."""
    pa, pb = ref.split_bf16(a), ref.split_bf16(b)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i, j in TERMS:
        out = out + pa[i].float() @ pb[j].float()
    return out


def _emulate_kernel(q, k, v, *, causal, window, block_k=64):
    """The kernel's arithmetic in plain float32 torch ops: scores by the
    six-term split over two halves of hd, added, scaled after the dot,
    masked to -1e30 (-inf past L); the online softmax over key tiles;
    each tile's p split into three parts against v's and folded into
    acc; acc / max(l, 1e-30)."""
    q, k, v = (torch.as_tensor(a) for a in (q, k, v))
    BH, S, hd = q.shape
    L = k.shape[1]
    kt = k.transpose(1, 2)
    h = hd // 2
    s_all = (_split_matmul(q[..., :h], kt[:, :h])
             + _split_matmul(q[..., h:], kt[:, h:])) * hd ** -0.5
    i = torch.arange(S)[:, None]
    m = torch.full((BH, S, 1), -1e30)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, hd))
    for k0 in range(0, L, block_k):
        j = torch.arange(k0, min(k0 + block_k, L))[None, :]
        s = s_all[:, :, k0:k0 + block_k]
        hide = torch.zeros((S, j.shape[1]), dtype=torch.bool)
        if causal:
            hide |= j > i
        if window > 0:
            hide |= j <= i - window
        s = torch.where(hide[None], torch.full_like(s, -1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + _split_matmul(p, v[:, k0:k0 + block_k])
        m = m_new
    return (acc / l.clamp_min(1e-30)).numpy()


@pytest.mark.parametrize("S,hd,causal,window", [
    (128, 64, True, 0), (256, 128, True, 0), (256, 64, False, 0),
    (256, 64, True, 64), (384, 128, False, 100)])
def test_split_emulation_matches_pallas(S, hd, causal, window):
    q, k, v = _qkv(np.random.default_rng(S + hd + window), 2, S, hd)
    got = _emulate_kernel(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(
        got, _pallas(q, k, v, 128, 128, causal=causal, window=window),
        rtol=TOL, atol=TOL)


def test_split_emulation_is_one_pass_for_bf16_inputs():
    """On bf16 inputs every term but hi.hi of q.k, and of p.v every term
    against v's mid and lo parts, is zero: the float32 kernel on widened
    bf16 inputs runs the bf16 kernel's passes plus exact zeros."""
    rng = np.random.default_rng(5)
    q, k = (torch.as_tensor(a).to(torch.bfloat16).float()
            for a in _qkv(rng, 2, 64, 64)[:2])
    pq, pk = ref.split_bf16(q), ref.split_bf16(k.transpose(1, 2))
    for i, j in TERMS:
        if (i, j) != (0, 0):
            assert not bool((pq[i].float() @ pk[j].float()).any())
