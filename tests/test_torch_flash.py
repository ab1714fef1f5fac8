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
