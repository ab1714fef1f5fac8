"""Fused per-round kernels: the wrappers of ``csrc/sv_predict.cu`` and
``csrc/primal_step.cu``.

- :func:`sv_predict` replaces ``repro/kernels/fused.py::sv_predict_pallas``:
  the SV family's predictions yhat_i = sum_j k(x_i, s_ij) a_ij, only
  the (B,) predictions leave the kernel.
- :func:`primal_step` replaces ``repro/kernels/fused.py::primal_step_pallas``:
  the RFF / linear families' whole round (featurize, predict, loss and
  gradient, update) in one launch.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream and
counts the launch (``_build.LAUNCH_COUNTS``).  A CPU tensor goes to
the plain version in ``ref.py``; a CUDA tensor goes to the kernel, or
the wrapper raises.

How a call splits its rows is computed here, so that the CPU tests
reach the arithmetic of the ragged edge: :func:`sv_predict_geometry`
and :func:`primal_step_geometry` give each row a thread-block cluster
of ``cluster`` blocks, block r owning the items [r chunk, min(n, (r + 1)
chunk)) of the row (budget slots, or RFF features).  The linear step
gives each learner one warp instead (``cluster`` 1), whose lane l owns
the features l, l + ``chunk``, ... (``chunk`` 32, the warp's width),
``LINEAR_WARPS`` learners a block.  ``cluster`` and ``chunk`` depend on
the budget N or the feature count D alone, never on the number of rows,
so a row's floats never depend on the batch around it.  The C entry
points check the split, lay out their shared memory themselves and
refuse what does not fit a block.

The geometry functions are the defaults that
``autotune.tuned_blocks`` resolves (ops ``sv_predict``, ``rff_step``
and ``linear_step``), each new one reported to ``CompileCounter``; a
wrapper's ``block_n`` / ``block_m`` gives a row's ``chunk`` instead
(``cluster`` follows from it).  A timed search keeps to the default:
another split sums in another order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, autotune, ref

KINDS = {"gaussian": 0, "linear": 1, "poly": 2}
LOSSES = {"hinge": 0, "squared": 1}

SV_SLOTS = 128          # budget slots a block aims at (its threads)
RFF_FEATURES = 256      # RFF features a block aims at (its threads)
MAX_CLUSTER = 8         # the portable thread-block cluster size
WARP = 32               # a linear learner's lanes (its feature stride)
LINEAR_WARPS = 8        # linear learners a block, a warp each


class Geometry(NamedTuple):
    """Each row's split: ``cluster`` blocks, block r owning the items
    [r chunk, min(n, (r + 1) chunk))."""
    cluster: int
    chunk: int


def _split(n: int, per_block: int) -> Geometry:
    """At most MAX_CLUSTER blocks of about ``per_block`` items for n
    items, ``chunk = ceil(n / cluster)``; no block is empty."""
    cluster = max(1, min(MAX_CLUSTER, -(-n // per_block)))
    return Geometry(cluster, -(-n // cluster))


@_build.compiled_cache
def sv_predict_geometry(N: int, d: int) -> Geometry:
    """The cluster split of a budget of N slots of d features: C =
    min(8, ceil(N / 128)) blocks, chunk = ceil(N / C)."""
    if N < 0 or d < 1:
        raise ValueError(f"sv_predict: budget {N}, dimension {d}")
    return _split(N, SV_SLOTS)


@_build.compiled_cache
def primal_step_geometry(D: int, featurize: bool) -> Geometry:
    """The split of a primal learner's D features.  RFF: C = min(8,
    ceil(D / 256)) blocks, chunk = ceil(D / C).  Linear: one warp a
    learner (cluster 1), lane l owning the features l, l + 32, ...
    (chunk 32) for every D."""
    if D < 0 or (not featurize and D < 1):
        raise ValueError(f"primal_step: D {D}")
    return _split(D, RFF_FEATURES) if featurize else Geometry(1, WARP)


def _chunk_geometry(n: int, chunk: int) -> Geometry:
    """The cluster of a row of n items split into blocks of ``chunk``."""
    return Geometry(max(1, -(-n // chunk)) if chunk else 1, chunk)


def _chunk_check(op: str):
    """The check of an explicit ``chunk`` for ``op``: at most
    MAX_CLUSTER blocks of it cover a row of dims[0] items."""
    def check(dims, blocks) -> None:
        n = dims[0]
        if len(blocks) != 1 or blocks[0] < 0 or (n > 0 and (
                blocks[0] == 0 or -(-n // blocks[0]) > MAX_CLUSTER)):
            raise ValueError(f"{op}: a chunk of {blocks} cannot split {n} "
                             f"items over at most {MAX_CLUSTER} blocks")
    return check


def _linear_step_check(dims, blocks) -> None:
    if blocks != (WARP,):
        raise ValueError(f"linear_step: a learner is one warp, lane stride "
                         f"{WARP} (block_m={WARP}), not {blocks}")


_sv_check, _rff_step_check = _chunk_check("sv_predict"), \
    _chunk_check("rff_step")
autotune.register("sv_predict", check=_sv_check,
                  default=lambda dims: (sv_predict_geometry(*dims).chunk,))
autotune.register(
    "rff_step", check=_rff_step_check,
    default=lambda dims: (primal_step_geometry(dims[0], True).chunk,))
autotune.register(
    "linear_step", check=_linear_step_check,
    default=lambda dims: (primal_step_geometry(dims[0], False).chunk,))


def sv_predict(X, SV, A, *, kind="gaussian", gamma=1.0, degree=3,
               coef0=1.0, block_n=None) -> torch.Tensor:
    """X (B, d), SV (B, N, d), A (B, N) -> (B,) fp32; padded slots must
    carry A = 0.  ``block_n``: the budget slots a block of a row's
    cluster owns (its ``chunk``); None resolves through
    ``autotune.tuned_blocks("sv_predict", (N, d))``."""
    B, N, d = SV.shape
    if X.shape != (B, d) or A.shape != (B, N):
        raise ValueError(f"sv_predict shapes X {tuple(X.shape)}, SV "
                         f"{tuple(SV.shape)}, A {tuple(A.shape)}")
    if kind not in KINDS:
        raise ValueError(f"unknown kernel {kind!r}")
    if block_n is None:
        (block_n,) = autotune.tuned_blocks("sv_predict", (N, d),
                                           kind=f"{kind}:d={d}")
    else:
        _sv_check((N, d), (block_n,))
    if X.device.type == "cpu":
        return ref.sv_predict_ref(X, SV, A, kind=kind, gamma=gamma,
                                  degree=degree, coef0=coef0)
    if X.device.type != "cuda":
        raise ValueError(f"sv_predict: unsupported device {X.device}")
    _build.check_operands("sv_predict", X.device, X=X, SV=SV, A=A)
    geo = _chunk_geometry(N, block_n)
    out = torch.empty((B,), dtype=torch.float32, device=X.device)
    _build.launch(
        "sv_predict", "repro_sv_predict", X.device,
        _build.ptr(X), _build.ptr(SV), _build.ptr(A), _build.ptr(out),
        B, N, d, KINDS[kind], float(gamma), int(degree), float(coef0),
        *geo, _build.stream_of(X))
    return out


def primal_step(X, Yl, w, b, *, W=None, bias=None, scale=1.0,
                loss="hinge", eta=0.5, lam=0.01, block_m=None):
    """One fused round for B stacked primal learners: X (B, d), labels
    (B,), w (B, D), b (B,) [, W (D, d), bias (D,)] -> (w_new, b_new,
    ell, yhat).  Without ``W`` the features are z = x (D == d).
    ``block_m``: RFF, the features a block of a learner's cluster owns
    (its ``chunk``); linear, the lane stride of a learner's warp (32
    only).  None resolves through ``autotune.tuned_blocks`` (op
    ``rff_step`` or ``linear_step``, dims (D,))."""
    B, d = X.shape
    D = w.shape[1] if w.dim() == 2 else -1
    featurize = W is not None
    if w.shape != (B, D) or Yl.shape != (B,) or b.shape != (B,):
        raise ValueError(f"primal_step shapes X {tuple(X.shape)}, y "
                         f"{tuple(Yl.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}")
    if featurize:
        if bias is None or W.shape != (D, d) or bias.shape != (D,):
            raise ValueError("primal_step: W must be (D, d) and bias (D,)")
    elif D != d:
        raise ValueError(f"primal_step: linear step needs D == d, got {D}, {d}")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    op = "rff_step" if featurize else "linear_step"
    if block_m is None:
        (block_m,) = autotune.tuned_blocks(op, (D,),
                                           kind=f"d={d}:D={D}:{loss}")
    else:
        (_rff_step_check if featurize else _linear_step_check)(
            (D,), (block_m,))
    if X.device.type == "cpu":
        return ref.primal_step_ref(X, Yl, w, b, W=W, bias=bias, scale=scale,
                                   loss=loss, eta=eta, lam=lam)
    if X.device.type != "cuda":
        raise ValueError(f"primal_step: unsupported device {X.device}")
    operands = dict(X=X, Yl=Yl, w=w, b=b)
    if featurize:
        operands.update(W=W, bias=bias)
    _build.check_operands("primal_step", X.device, **operands)
    geo = _chunk_geometry(D, block_m) if featurize else Geometry(1, WARP)
    dev = X.device
    w_new = torch.empty((B, D), dtype=torch.float32, device=dev)
    b_new = torch.empty((B,), dtype=torch.float32, device=dev)
    ell = torch.empty((B,), dtype=torch.float32, device=dev)
    yhat = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        op, "repro_primal_step", dev,
        _build.ptr(X), _build.ptr(Yl), _build.ptr(w), _build.ptr(b),
        _build.ptr(W), _build.ptr(bias), _build.ptr(w_new),
        _build.ptr(b_new), _build.ptr(ell), _build.ptr(yhat),
        B, d, D, int(featurize), float(scale), LOSSES[loss], float(eta),
        float(1.0 - eta * lam), *geo, _build.stream_of(X))
    return w_new, b_new, ell, yhat
