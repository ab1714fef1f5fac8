"""The port's ``ops.gram`` / ``gram_spec`` against the JAX package's.

On the CPU the port's kernel branch runs the kernel's plain version
(``ref.gram_ref``); the reference's ``ops.gram_spec(...,
force_pallas=True)`` runs its Pallas kernel in interpret mode, and
``rkhs.gram`` is the algebra its substrates use.  Kinds gaussian, poly
and linear; shapes (1, 1), (127, 129), (130, 150), (256, 384); d in
{1, 6, 18}; rtol = atol = 2e-5, the JAX package's own Gram tolerance
(tests/test_kernels_pallas.py).  On the CPU no call launches a kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rkhs as jrkhs
from repro.kernels import ops as jops

from repro_torch.core import rkhs as trkhs
from repro_torch.kernels import gram, ops, ref

TOL = 2e-5
KINDS = ["gaussian", "poly", "linear"]
SHAPES = [(1, 1), (127, 129), (130, 150), (256, 384)]


def _data(M, N, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, d)).astype(np.float32),
            rng.normal(size=(N, d)).astype(np.float32))


@pytest.mark.parametrize("d", [1, 6, 18])
@pytest.mark.parametrize("M,N", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_gram_spec_matches_pallas(kind, M, N, d):
    X, Y = _data(M, N, d, seed=M * 1000 + N + d)
    jspec = jrkhs.KernelSpec(kind, gamma=0.5)
    tspec = trkhs.KernelSpec(kind, gamma=0.5)
    want = np.asarray(jops.gram_spec(jspec, jnp.asarray(X), jnp.asarray(Y),
                                     force_pallas=True))
    ops.reset_launch_counts()
    got = ops.gram_spec(tspec, torch.as_tensor(X), torch.as_tensor(Y),
                        force_kernel=True)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU call launched"
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrkhs.gram(jspec, jnp.asarray(X),
                                           jnp.asarray(Y))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("M,N", [(127, 127), (128, 1), (1, 128), (200, 3)])
def test_gram_engages_like_the_reference(M, N):
    """The kernel branch is taken at max(M, N) >= 128, as the
    reference's; on the CPU both branches are the plain version, and
    no launch is counted."""
    X, Y = (torch.as_tensor(a) for a in _data(M, N, 6, seed=M + N))
    assert ops.engages(M, N) == (max(M, N) >= 128)
    ops.reset_launch_counts()
    got = ops.gram(X, Y, kind="gaussian", gamma=0.3)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0
    np.testing.assert_array_equal(
        got.numpy(), ref.gram_ref(X, Y, kind="gaussian", gamma=0.3).numpy())
    np.testing.assert_array_equal(
        got.numpy(), gram.gram(X, Y, kind="gaussian", gamma=0.3).numpy())


def test_gram_widens_bf16_inputs_as_the_reference():
    X, Y = (jnp.asarray(a, jnp.bfloat16) for a in _data(128, 130, 16, 9))
    want = np.asarray(jops.gram(X, Y, kind="gaussian", gamma=1.0,
                                force_pallas=True))
    tX, tY = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
              for a in (X, Y))
    got = ops.gram(tX, tY, kind="gaussian", gamma=1.0, force_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_gram_wrapper_refuses_what_it_cannot_take():
    X, Y = (torch.as_tensor(a) for a in _data(3, 4, 5, 0))
    with pytest.raises(ValueError, match="shapes"):
        gram.gram(X, Y[:, :4])
    with pytest.raises(ValueError, match="unknown kernel"):
        gram.gram(X, Y, kind="laplace")
