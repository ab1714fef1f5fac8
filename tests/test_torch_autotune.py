"""``repro_torch.kernels.autotune`` and the ``block_*`` keywords of
``kernels/ops.py``, on the CPU.

The reference's contracts (tests/test_kernels_fused.py:197-262) with
the port's geometries: candidates never pass the padded extent and
each is bitwise the default's output (a cluster split keeps one, the
default; ``rff``'s rows a thread have several); off the card the
resolution is deterministic, launches nothing and records
``source="default"``; ``pin`` overrides; a value-equal op adds no
compile across ``clear_cache`` (``CompileCounter``); an explicit
``block_*`` the kernel cannot take raises ``ValueError``.  The search
itself runs here against a stand-in for the card (``torch.cuda``'s
checks patched; ``time_fn`` waits only for CUDA tensors), and never
while a CUDA graph is being captured.  The ops' outputs with an
explicit geometry are held to the JAX package's plain versions
(``repro.kernels.ref``) within the parity pair.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import assert_backend_parity

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import autotune, fused, ops
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import quadform as qf_mod
from repro_torch.kernels import rff as rff_mod
from repro_torch.telemetry import CompileCounter


@pytest.fixture(autouse=True)
def _fresh_table():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


@pytest.fixture
def card(monkeypatch):
    """The resolver sees a card and no capture in progress."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_public_names_and_the_reference_keywords():
    for name in ("TileKey", "TileChoice", "candidates_for", "default_blocks",
                 "tuned_blocks", "pin", "cache_info", "clear_cache"):
        assert hasattr(autotune, name), name
    for name in ("gram", "rff_features", "quadform", "sv_predict",
                 "fused_primal_step"):
        want = {k for k in inspect.signature(getattr(jops, name)).parameters
                if k.startswith("block_")}
        got = set(inspect.signature(getattr(ops, name)).parameters)
        assert want and want <= got, (name, want - got)


@pytest.mark.parametrize("D", [32, 2048, 5000])
def test_rff_candidates_stay_in_the_padded_extent(D):
    """Every row block up to M rounded up to the default's, the default
    always among them, 32 columns each; M from 1 to 79 and four larger."""
    for M in list(range(1, 80)) + [127, 128, 1000, 4097]:
        default = autotune.default_blocks("rff", (M, D))
        cands = autotune.candidates_for("rff", (M, D))
        assert default == (8 * rff_mod.rff_geometry(M, D).rows_per_thread,
                           32)
        assert default in cands and cands[0] == (8, 32)
        padded = -(-M // default[0]) * default[0]
        assert all(rows <= padded and cols == 32 for rows, cols in cands)
        assert [r for r, _ in cands] == [r for r in rff_mod.ROW_BLOCKS
                                         if r <= padded], (M, D)


def test_cluster_ops_keep_their_one_default():
    """``sv_predict`` and the RFF step: one candidate, the geometry
    function's chunk, and the split it implies is the function's, at
    every n to 299 and around the cluster's edges."""
    for n in list(range(0, 300)) + [1023, 1024, 1025, 2047, 2048, 2049,
                                    40000]:
        _one_default(n)


def _one_default(n):
    sv = autotune.default_blocks("sv_predict", (n, 18))
    step = autotune.default_blocks("rff_step", (n,))
    assert autotune.candidates_for("sv_predict", (n, 18)) == (sv,)
    assert autotune.candidates_for("rff_step", (n,)) == (step,)
    assert fused._chunk_geometry(n, sv[0]) == fused.sv_predict_geometry(n, 18)
    assert fused._chunk_geometry(n, step[0]) == \
        fused.primal_step_geometry(n, True)
    assert sv[0] <= n and step[0] <= n
    if n:
        assert autotune.candidates_for("linear_step", (n,)) == ((32,),)
    for op, tile in (("gram", (128, 128)), ("quadform", (64, 128))):
        dims = (max(n, 1), 7)
        assert autotune.candidates_for(op, dims) == (tile,)
        assert autotune.default_blocks(op, dims) == tile


def test_resolution_off_the_card_is_deterministic_and_launches_nothing(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    b1 = autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                               measure=calls.append)
    b2 = autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                               measure=calls.append)
    assert b1 == b2 == autotune.default_blocks("rff", (64, 2048)) == (32, 32)
    assert calls == [], "no search may run off the card"
    key = autotune.TileKey("rff", (64, 2048), "float32", "d=18")
    assert autotune.cache_info()[key] == autotune.TileChoice(
        (32, 32), "default")
    with pytest.raises(ValueError, match="no geometry"):
        autotune.tuned_blocks("op", (300, 40))


def test_no_search_while_a_graph_is_captured(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    calls = []
    assert autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                                 measure=calls.append) == (32, 32)
    assert calls == []
    assert autotune.cache_info()[("rff", (64, 2048), "float32",
                                  "d=18")].source == "default"


def test_search_times_every_candidate_and_holds_them_bitwise(card):
    """On the card a ``measure`` thunk is timed at each candidate (here
    the plain ``rff`` on the CPU, which no geometry changes); the
    fastest is cached with every time; a second resolution is a hit."""
    rng = np.random.default_rng(0)
    X, W, b = (torch.from_numpy(_f32(rng, *s)) for s in ((64, 18),
                                                         (2048, 18), (2048,)))
    seen = []

    def measure(blocks):
        seen.append(blocks)
        return rff_mod.rff(X, W, b, block_m=blocks[0], block_d=blocks[1])

    blocks = autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                                   measure=measure)
    choice = autotune.cache_info()[("rff", (64, 2048), "float32", "d=18")]
    cands = autotune.candidates_for("rff", (64, 2048))
    assert len(cands) == 4 and choice.source == "search"
    assert [bt for bt, _ in choice.times_ms] == list(cands)
    assert all(ms > 0 for _, ms in choice.times_ms)
    assert blocks == choice.blocks and blocks in cands
    assert set(seen) == set(cands)
    n = len(seen)
    with CompileCounter() as c:
        assert autotune.tuned_blocks("rff", (64, 2048), kind="d=18",
                                     measure=measure) == blocks
    assert len(seen) == n and c.compiles == 0
    # a candidate whose output is not bitwise the first's is refused
    autotune.clear_cache()
    with pytest.raises(RuntimeError, match="not bitwise"):
        autotune.tuned_blocks(
            "rff", (64, 2048), kind="d=18",
            measure=lambda blk: torch.full((2,), float(blk[0])))


def test_pin_overrides_and_is_checked():
    rng = np.random.default_rng(1)
    X, SV, A = _f32(rng, 3, 9), _f32(rng, 3, 256, 9), _f32(rng, 3, 256)
    autotune.pin("sv_predict", (256, 9), (64,), kind="gaussian:d=9")
    assert autotune.tuned_blocks("sv_predict", (256, 9),
                                 kind="gaussian:d=9") == (64,)
    assert autotune.cache_info()[("sv_predict", (256, 9), "float32",
                                  "gaussian:d=9")].source == "pinned"
    got = ops.sv_predict(*map(torch.from_numpy, (X, SV, A)), gamma=0.5)
    assert_backend_parity(got.numpy(), jref.sv_predict_ref(
        jnp.asarray(X), jnp.asarray(SV), jnp.asarray(A), gamma=0.5),
        "pinned chunk 64")
    for op, dims, blocks in (("sv_predict", (256, 9), (16,)),
                             ("rff", (64, 2048), (24, 32)),
                             ("gram", (300, 300), (256, 128)),
                             ("linear_step", (18,), (64,))):
        with pytest.raises(ValueError):
            autotune.pin(op, dims, blocks)


def test_value_equal_ops_reuse_compiled_work_across_a_cleared_table():
    rng = np.random.default_rng(2)
    X, SV, A = (torch.from_numpy(_f32(rng, *s))
                for s in ((3, 9), (3, 200, 9), (3, 200)))
    Xr, Wr, br = (torch.from_numpy(_f32(rng, *s))
                  for s in ((130, 9), (256, 9), (256,)))
    ops.sv_predict(X, SV, A, gamma=0.5)               # warm: may compile
    ops.rff_features(Xr, Wr, br)
    with CompileCounter() as c:
        ops.sv_predict(X, SV, A, gamma=0.5)
        ops.rff_features(Xr, Wr, br)
        autotune.clear_cache()
        ops.sv_predict(X, SV, A, gamma=0.5)
        ops.rff_features(Xr, Wr, br)
    assert c.compiles == 0, c.events
    assert {k.op for k in autotune.cache_info()} == {"sv_predict", "rff"}
    assert all(v.source == "default" for v in autotune.cache_info().values())


def test_explicit_blocks_run_or_raise():
    """A geometry the kernel takes gives the plain version's numbers
    (the JAX package's within the parity pair); one it cannot take
    raises ``ValueError``, on the CPU as on the card."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy
    X, Y = _f32(rng, 130, 5), _f32(rng, 140, 5)
    assert_backend_parity(
        ops.gram(t(X), t(Y), gamma=0.3, block_m=128, block_n=128).numpy(),
        jref.gram_ref(jnp.asarray(X), jnp.asarray(Y), gamma=0.3), "gram")
    with pytest.raises(ValueError, match="compiled in"):
        ops.gram(t(X), t(Y), block_m=256, block_n=128)
    P, a, b = 2, _f32(rng, 2, 130), _f32(rng, 2, 140)
    Xq, Yq = np.stack([X] * P), np.stack([Y] * P)
    got = ops.quadform(t(Xq), t(Yq), t(a), t(b), gamma=0.3, block_m=64,
                       block_n=128)
    want = [jref.quadform_ref(jnp.asarray(X), jnp.asarray(Y),
                              jnp.asarray(a[p]), jnp.asarray(b[p]), gamma=0.3)
            for p in range(P)]
    assert_backend_parity(got.numpy(), np.asarray(want), "quadform")
    with pytest.raises(ValueError, match="compiled in"):
        qf_mod.quadform(t(Xq), t(Yq), t(a), t(b), block_m=128, block_n=128)
    Wr, br = _f32(rng, 300, 5), _f32(rng, 300)
    want = jref.rff_ref(jnp.asarray(X), jnp.asarray(Wr), jnp.asarray(br))
    for rows in rff_mod.ROW_BLOCKS:
        assert_backend_parity(
            ops.rff_features(t(X), t(Wr), t(br), block_m=rows,
                             block_d=32).numpy(), want, f"rff rows {rows}")
    for bad in ((12, 32), (8, 64)):
        with pytest.raises(ValueError, match="rows a block"):
            ops.rff_features(t(X), t(Wr), t(br), block_m=bad[0],
                             block_d=bad[1])
    Xs, SV, A = _f32(rng, 2, 5), _f32(rng, 2, 1024, 5), _f32(rng, 2, 1024)
    want = jref.sv_predict_ref(jnp.asarray(Xs), jnp.asarray(SV),
                               jnp.asarray(A), gamma=0.2)
    for chunk in (128, 256, 1024):
        assert_backend_parity(
            ops.sv_predict(t(Xs), t(SV), t(A), gamma=0.2,
                           block_n=chunk).numpy(), want, f"sv {chunk}")
    for chunk in (0, 64, -1):          # 16 blocks a row, none, negative
        with pytest.raises(ValueError, match="chunk"):
            ops.sv_predict(t(Xs), t(SV), t(A), block_n=chunk)
    w, bb = _f32(rng, 130, 300), _f32(rng, 130)
    Xp, yl = _f32(rng, 130, 5), np.sign(_f32(rng, 130)).astype(np.float32)
    got = ops.fused_primal_step(t(Xp), t(yl), t(w), t(bb), W=t(Wr),
                                bias=t(br), scale=0.08, block_m=150)
    want = jref.primal_step_ref(*map(jnp.asarray, (Xp, yl, w, bb)),
                                W=jnp.asarray(Wr), bias=jnp.asarray(br),
                                scale=0.08)
    for g, wv in zip(got, want):
        assert_backend_parity(g.numpy(), wv, "rff step chunk 150")
    with pytest.raises(ValueError, match="chunk"):
        ops.fused_primal_step(t(Xp), t(yl), t(w), t(bb), W=t(Wr),
                              bias=t(br), block_m=32)     # 10 blocks
    wl = _f32(rng, 130, 5)
    with pytest.raises(ValueError, match="warp"):
        ops.fused_primal_step(t(Xp), t(yl), t(wl), t(bb), block_m=64)
    assert gram_mod.TILE == (128, 128) and qf_mod.TILE == (64, 128)
