"""The port's ``rff`` kernel face against the JAX package's.

``repro_torch.kernels.ops.rff_features`` (on the CPU: the plain
version ``ref.rff_ref``, which is what the wrapper runs for a CPU
tensor) against ``repro.kernels.ops.rff_features(force_pallas=True)``,
the Pallas kernel in interpret mode, at M, D in {1, 127, 128, 129, 130}
and d in {6, 18}; then the substrate's engage-aware featurization.
The tolerance is the suite's one parity pair.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import PARITY_ATOL, PARITY_RTOL

from repro.kernels import ops as jops

from repro_torch.core import rff as trff
from repro_torch.core import substrate as tsub
from repro_torch.core.rff import RFFSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rff as rff_kernel

EDGES = [1, 127, 128, 129, 130]


def _inputs(M, D, d, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    X = (scale * rng.normal(size=(M, d))).astype(np.float32)
    W = (0.5 * rng.normal(size=(D, d))).astype(np.float32)
    b = rng.uniform(0.0, 2.0 * np.pi, size=(D,)).astype(np.float32)
    return X, W, b


@pytest.mark.parametrize("d", [6, 18])
@pytest.mark.parametrize("D", EDGES)
@pytest.mark.parametrize("M", EDGES)
def test_rff_features_match_pallas(M, D, d, backend_parity):
    X, W, b = _inputs(M, D, d, seed=M * 1000 + D + d)
    want = np.asarray(jops.rff_features(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(b), force_pallas=True))
    ops.reset_launch_counts()
    got = ops.rff_features(torch.as_tensor(X), torch.as_tensor(W),
                           torch.as_tensor(b), force_kernel=True)
    assert sum(ops.LAUNCH_COUNTS.values()) == 0, "a CPU call launched"
    assert got.shape == (M, D) and got.dtype == torch.float32
    backend_parity(got.numpy(), want, f"rff M={M} D={D} d={d}")
    # the engaged and the plain branch are one function on the CPU
    np.testing.assert_array_equal(
        got.numpy(), ref.rff_ref(torch.as_tensor(X), torch.as_tensor(W),
                                 torch.as_tensor(b)).numpy())


def test_rff_large_arguments_and_num_features():
    """Arguments of order 10 (inputs scaled x10) keep full-precision
    cos; ``num_features`` sets the scale as the reference's does."""
    X, W, b = _inputs(64, 130, 18, seed=7, scale=10.0)
    for nf in (None, 512):
        want = np.asarray(jops.rff_features(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(b),
            num_features=nf, force_pallas=True))
        got = ops.rff_features(torch.as_tensor(X), torch.as_tensor(W),
                               torch.as_tensor(b), num_features=nf)
        np.testing.assert_allclose(got.numpy(), want, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
        assert float(np.max(np.abs(got.numpy()))) <= math.sqrt(
            2.0 / (nf or 130)) * (1 + 1e-6)


def test_rff_rows_do_not_depend_on_the_batch():
    """Row i of an M-row call equals the 1-row call bitwise (the
    serving contract), on the path the CPU runs."""
    X, W, b = (torch.as_tensor(a) for a in _inputs(64, 2048, 18, seed=3))
    full = ops.rff_features(X, W, b)
    for M in (1, 2, 4, 13, 16, 64):
        assert torch.equal(ops.rff_features(X[:M], W, b), full[:M])
    for i in (0, 17, 63):
        assert torch.equal(ops.rff_features(X[i:i + 1], W, b)[0], full[i])


def test_rff_wrapper_refuses_bad_operands():
    X, W, b = (torch.as_tensor(a) for a in _inputs(4, 130, 6))
    with pytest.raises(ValueError):
        rff_kernel.rff(X, W[:, :5], b)           # d mismatch
    with pytest.raises(ValueError):
        rff_kernel.rff(X, W, b[:-1])             # bias length
    with pytest.raises(ValueError):
        rff_kernel.rff(X[0], W, b)               # X must be 2-D
    with pytest.raises(ValueError):
        rff_kernel.rff(X.to("meta"), W.to("meta"), b.to("meta"))


@pytest.mark.parametrize("D", [32, 256])
def test_substrate_featurizes_through_rff_features_when_engaged(D,
                                                                monkeypatch):
    """Under ``"kernels"`` the RFF substrate's predict path featurizes
    through ``ops.rff_features`` exactly when max(n, D) >= 128, as the
    reference's ``_phi`` does; the fused round never does."""
    spec = RFFSpec(dim=6, num_features=D, gamma=0.3, seed=0)
    sub = tsub.RFFSubstrate(spec=spec, backend="kernels").on(
        torch.device("cpu"))
    calls = []
    real = ops.rff_features
    monkeypatch.setattr(ops, "rff_features",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    models = sub.init(3, "cpu")
    x = torch.as_tensor(_inputs(3, D, 6)[0])
    sub.predict(models, x)
    sub.predict_batch(models, torch.tensor([0, 2, 2, 0]),
                      torch.zeros(4, 6))
    sub.predict_one(trff.RFFLearnerState(w=models.w[1], b=models.b[1]), x[1])
    sub.round_stacked(models, (x, torch.ones(3)))
    assert calls == ([(3, 6), (4, 6), (1, 6)] if D >= 128 else [])


def _rows_per_thread_is_least(M, geo):
    """R is the least of 1, 2, 4, 8 whose row tiles number at most the
    ones wanted for about FILL_BLOCKS blocks (8 when none does)."""
    want = -(-rff_kernel.FILL_BLOCKS // geo.col_tiles)
    tiles = {R: -(-M // (rff_kernel.RFF_WARPS * R))
             for R in rff_kernel.ROWS_PER_THREAD}
    fits = [R for R in rff_kernel.ROWS_PER_THREAD if tiles[R] <= want]
    return geo.rows_per_thread == (fits[0] if fits else 8)


@pytest.mark.parametrize("axis", ["M", "D"])
def test_rff_geometry_covers_every_element_once(axis):
    """``rff_geometry`` (the wrapper's tile plan; csrc/rff.cu refuses any
    R but 1, 2, 4, 8) for M, then D, from 1 to 5000 beside the other at
    serving's and the edges' sizes: 32-column tiles cover [0, D) and
    8 R-row tiles cover [0, M), each once (the tiles past the grid's y
    extent: the next test); R is the least that gives about one block
    per SM; the plan depends on M and D only."""
    others = [1, 31, 32, 33, 130, 2048, 5000]
    pairs = ([(n, o) for n in range(1, 5001) for o in others] if axis == "M"
             else [(o, n) for n in range(1, 5001) for o in others])
    for M, D in pairs:
        geo = rff_kernel.rff_geometry(M, D)
        cols = rff_kernel.RFF_COLS
        rows = rff_kernel.RFF_WARPS * geo.rows_per_thread
        assert geo.rows_per_thread in rff_kernel.ROWS_PER_THREAD
        assert (geo.col_tiles - 1) * cols < D <= geo.col_tiles * cols
        assert (geo.row_tiles - 1) * rows < M <= geo.row_tiles * rows
        assert geo.grid == (geo.col_tiles,
                            min(geo.row_tiles, rff_kernel.MAX_GRID_Y))
        assert _rows_per_thread_is_least(M, geo), (M, D, geo)
    # serving's buckets at D = 2048: 128 blocks from M = 16 on
    for M, R in ((1, 1), (8, 1), (16, 1), (32, 2), (64, 4), (128, 8)):
        geo = rff_kernel.rff_geometry(M, 2048)
        assert geo.rows_per_thread == R, (M, geo)
        if M >= 16:
            assert geo.grid == (64, 2)


def test_rff_geometry_takes_row_tiles_past_the_grid_in_a_loop():
    """At M beyond 65535 row tiles the grid's y extent stops at 65535
    and each block walks its tiles y, y + 65535, ...: every tile once."""
    M = 8 * 8 * 65535 + 3 * 64 + 5          # 8 rows a thread at D = 32
    geo = rff_kernel.rff_geometry(M, 32)
    assert geo.rows_per_thread == 8 and geo.row_tiles == 65535 + 4
    gy = geo.grid[1]
    assert gy == rff_kernel.MAX_GRID_Y
    seen = sorted(t for y in range(gy) for t in range(y, geo.row_tiles, gy))
    assert seen == list(range(geo.row_tiles))
