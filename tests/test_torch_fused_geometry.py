"""How the cluster kernels split a row, on the CPU.

``kernels/fused.py::sv_predict_geometry`` and ``primal_step_geometry``
give each row of ``csrc/sv_predict.cu`` and of the RFF path of
``csrc/primal_step.cu`` a thread-block cluster: ``cluster`` blocks,
block r owning the items [r chunk, min(n, (r + 1) chunk)) of the row.
The C side only checks the split (and lays out its own shared memory),
so the split's arithmetic is tested here:

- the cluster split depends on the budget N or the feature count D
  alone (not on d, and there is no batch argument at all);
- for every N and D from 1 to 5000 the blocks cover [0, n) once, with
  no gap, no overlap and no empty block, at most 8 blocks a cluster;
- a plain float32 emulation of the kernel's slot order (thread t of
  block r adds slots r chunk + t, + 128, ...; then the block, then the
  cluster in rank order) equals the plain version within the parity
  pair at the edges, so every slot is counted once;
- the linear step's split (a warp a learner, ``LINEAR_WARPS`` learners
  a block, lane l owning the features l, l + 32, ...) covers every
  learner and every feature once, depends on D alone, and a float32
  emulation of its order (each lane's sum in feature order, the warp's
  shuffle tree, the update) equals the plain step within the parity
  pair, each learner's row the same whatever the batch around it;
- the geometry and the wrappers refuse what the kernels do not take,
  while the CPU path takes every width the plain version takes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused, ops, ref

PARITY_RTOL = 1e-3     # tests/conftest.py:42
PARITY_ATOL = 5e-3     # tests/conftest.py:43
SIZES = range(1, 5001)


def _blocks(n, geo):
    return [(min(n, r * geo.chunk), min(n, (r + 1) * geo.chunk))
            for r in range(geo.cluster)]


def _geometry(kernel, n, d):
    if kernel == "sv_predict":
        return fused.sv_predict_geometry(n, d)
    return fused.primal_step_geometry(n, True)


@pytest.mark.parametrize("kernel", ["sv_predict", "rff_step"])
def test_cluster_split_depends_on_n_alone(kernel):
    for n in list(range(1, 300)) + [1023, 1024, 1025, 2048, 2049, 4096]:
        splits = {_geometry(kernel, n, d) for d in (1, 7, 18, 33, 130)}
        assert len(splits) == 1, (n, splits)


@pytest.mark.parametrize("d", [1, 18, 33])
@pytest.mark.parametrize("kernel", ["sv_predict", "rff_step"])
def test_blocks_cover_every_item_once(kernel, d):
    per_block = (fused.SV_SLOTS if kernel == "sv_predict"
                 else fused.RFF_FEATURES)
    for n in SIZES:
        geo = _geometry(kernel, n, d)
        assert 1 <= geo.cluster <= fused.MAX_CLUSTER, (n, geo)
        assert geo.chunk <= per_block or geo.cluster == fused.MAX_CLUSTER, \
            (n, geo)
        blocks = _blocks(n, geo)
        assert blocks[0][0] == 0 and blocks[-1][1] == n, (n, geo)
        for (_, end), (start, _) in zip(blocks, blocks[1:]):
            assert end == start, (n, geo)        # no gap, no overlap
        assert all(end > start for start, end in blocks), (n, geo)
    # the engine's shapes: 8 blocks of 128 slots, 8 of 256 features
    assert fused.sv_predict_geometry(1024, 18) == (8, 128)
    assert fused.primal_step_geometry(2048, True) == (8, 256)


def test_geometry_fits_shared_memory():
    """The split leaves the shared-memory layout to the C side: on the
    CPU every width the plain version takes goes through, and the
    linear step takes one warp a learner, its lanes 32 features apart,
    at every D (it stages nothing)."""
    z = torch.zeros
    assert fused.sv_predict_geometry(4096, 40000) == (8, 512)
    assert torch.equal(fused.sv_predict(z(1, 40000), z(1, 2, 40000),
                                        z(1, 2)), z(1))
    w_new, b_new, ell, yhat = fused.primal_step(
        z(1, 60000), torch.ones(1), z(1, 60000), z(1))
    assert torch.equal(w_new, z(1, 60000)) and torch.equal(yhat, z(1))
    assert torch.equal(ell, torch.ones(1))
    assert fused.primal_step_geometry(18, False) == (1, 32)
    assert fused.primal_step_geometry(1000, False) == (1, 32)


def _emulate_sv_predict(X, SV, A, geo, **kw):
    """The kernel's order in float32 at a width whose tiles hold 128
    slots: per-slot terms k(x, s_j) a_j, each thread's slots 128 apart,
    a block's threads, then the cluster's blocks in rank order (the warp
    tree is not emulated: it reorders the same terms)."""
    terms = (ref.gram_ref(X[:, None, :], SV, **kw)[:, 0, :] * A).numpy()
    B, N = A.shape
    out = np.zeros(B, np.float32)
    for i in range(B):
        total = np.float32(0.0)
        for start, end in _blocks(N, geo):
            n = end - start
            part = np.float32(0.0)
            for t in range(min(fused.SV_SLOTS, n)):
                acc = np.float32(0.0)
                for j in range(start + t, end, fused.SV_SLOTS):
                    acc = np.float32(acc + terms[i, j])
                part = np.float32(part + acc)
            total = np.float32(total + part)
        out[i] = total
    return out


@pytest.mark.parametrize("N", [1, 127, 129, 1023, 1025, 4096])
def test_slot_order_emulation_matches_plain(N):
    rng = np.random.default_rng(N)
    X = torch.from_numpy(rng.normal(size=(2, 18)).astype(np.float32))
    SV = torch.from_numpy(rng.normal(size=(2, N, 18)).astype(np.float32))
    A = torch.from_numpy(rng.normal(size=(2, N)).astype(np.float32))
    kw = dict(kind="gaussian", gamma=0.05)
    got = _emulate_sv_predict(X, SV, A, fused.sv_predict_geometry(N, 18),
                              **kw)
    np.testing.assert_allclose(got, ref.sv_predict_ref(X, SV, A, **kw),
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ops.reset_launch_counts()
    z = torch.zeros
    # a geometry the kernels cannot take
    with pytest.raises(ValueError):
        fused.sv_predict_geometry(-1, 18)
    with pytest.raises(ValueError):
        fused.sv_predict_geometry(4, 0)
    with pytest.raises(ValueError):
        fused.primal_step_geometry(-1, True)
    with pytest.raises(ValueError):
        fused.primal_step_geometry(0, False)
    # an RFF step needs W (D, d) and bias (D,)
    with pytest.raises(ValueError):
        fused.primal_step(z(2, 3), z(2), z(2, 5), z(2), W=z(5, 4),
                          bias=z(5))
    with pytest.raises(ValueError):
        fused.primal_step(z(2, 3), z(2), z(2, 5), z(2), W=z(5, 3))
    # a device that is neither the CPU nor a CUDA card
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused.sv_predict(z(2, 3, **meta), z(2, 4, 3, **meta),
                         z(2, 4, **meta))
    with pytest.raises(ValueError, match="unsupported device"):
        fused.primal_step(z(2, 3, **meta), z(2, **meta), z(2, 5, **meta),
                          z(2, **meta), W=z(5, 3, **meta),
                          bias=z(5, **meta))
    assert sum(ops.LAUNCH_COUNTS.values()) == 0


def test_linear_split_covers_every_learner_and_feature_once():
    for D in SIZES:
        geo = fused.primal_step_geometry(D, False)
        assert geo == (1, fused.WARP), (D, geo)     # the same for every D
        owned = sorted(j for lane in range(geo.chunk)
                       for j in range(lane, D, geo.chunk))
        assert owned == list(range(D)), D
    for B in SIZES:
        blocks = -(-B // fused.LINEAR_WARPS)
        learners = [blk * fused.LINEAR_WARPS + warp for blk in range(blocks)
                    for warp in range(fused.LINEAR_WARPS)
                    if blk * fused.LINEAR_WARPS + warp < B]
        assert learners == list(range(B)), B


def _fma(a, b, c):
    """fmaf in float32 (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_linear_step(X, y, w, b, geo, *, eta, lam, loss):
    """The linear kernel's order in float32: lane l sums w_j x_j over
    j = l, l + chunk, ... by fmaf, the warp adds its lanes by the shuffle
    tree (offsets 16, 8, 4, 2, 1), lane 0 forms the loss and g; w' =
    fmaf(-eta g, x, decay w).  Learner by learner, in blocks of
    LINEAR_WARPS, as the grid runs them."""
    f32 = np.float32
    B, D = X.shape
    decay, eta32 = f32(1.0 - eta * lam), f32(eta)
    out = [np.zeros((B, D), f32)] + [np.zeros(B, f32) for _ in range(3)]
    for blk in range(-(-B // fused.LINEAR_WARPS)):
        for i in range(blk * fused.LINEAR_WARPS,
                       min(B, (blk + 1) * fused.LINEAR_WARPS)):
            lanes = np.zeros(fused.WARP, f32)
            for lane in range(geo.chunk):
                for j in range(lane, D, geo.chunk):
                    lanes[lane] = _fma(w[i, j], X[i, j], lanes[lane])
            o = fused.WARP // 2
            while o:
                lanes[:o] = lanes[:o] + lanes[o:2 * o]
                o //= 2
            yhat = f32(lanes[0] + b[i])
            if loss == "hinge":
                ell = max(f32(0.0), f32(f32(1.0) - f32(y[i] * yhat)))
                g = -y[i] if ell > 0 else f32(0.0)
            else:
                r = f32(yhat - y[i])
                ell, g = f32(f32(0.5) * r * r), r
            step = f32(eta32 * g)
            out[0][i] = _fma(np.full(D, -step, f32), X[i], decay * w[i])
            out[1][i] = f32(b[i] - step)
            out[2][i], out[3][i] = ell, yhat
    return out


@pytest.mark.parametrize("D", [1, 18, 31, 32, 33, 1000])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_linear_lane_order_emulation_matches_plain(loss, D):
    rng = np.random.default_rng(D)
    B = 13                                  # two blocks, the second ragged
    X = rng.normal(size=(B, D)).astype(np.float32)
    y = np.where(rng.random(B) < 0.5, -1.0, 1.0).astype(np.float32)
    w = (0.1 * rng.normal(size=(B, D))).astype(np.float32)
    b = rng.normal(size=B).astype(np.float32)
    kw = dict(eta=0.5, lam=0.01, loss=loss)
    geo = fused.primal_step_geometry(D, False)
    got = _emulate_linear_step(X, y, w, b, geo, **kw)
    want = ref.primal_step_ref(*map(torch.from_numpy, (X, y, w, b)), **kw)
    for g, v, name in zip(got, want, ("w", "b", "ell", "yhat")):
        np.testing.assert_allclose(g, v.numpy(), rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL, err_msg=name)
    # a learner's row is the one-learner call's, bitwise
    for i in (0, 7, 8, 12):
        one = _emulate_linear_step(X[i:i + 1], y[i:i + 1], w[i:i + 1],
                                   b[i:i + 1], geo, **kw)
        for g, o in zip(got, one):
            assert np.array_equal(g[i:i + 1], o), i
