"""Random Fourier features: the wrapper of ``csrc/rff.cu``.

Z = sqrt(2/D) cos(X W^T + b) for a batch of rows.  Replaces
``repro/kernels/rff.py::rff_pallas``; it serves every RFF featurization
off the engine's fused round: the serving buckets (``predict_batch``),
``predict_one`` and the stacked ``predict``.

The wrapper checks device, dtype, shape and contiguity, allocates Z
with ``torch.empty``, resolves the tiles (``autotune.tuned_blocks``,
op ``rff``, dims (M, D), whose default is ``rff_geometry``), launches
on the current stream and counts the launch
(``_build.LAUNCH_COUNTS["rff"]``).  A CPU tensor goes to the plain
version (``ref.rff_ref``); a CUDA tensor goes to the kernel, or the
wrapper raises.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build, autotune, ref

RFF_COLS = 32           # columns of Z a block, a lane each (kCols)
RFF_WARPS = 8           # a block's warps; a thread's rows are 8 apart
ROWS_PER_THREAD = (1, 2, 4, 8)
FILL_BLOCKS = 132       # blocks to aim for: the H100's SMs
MAX_GRID_Y = 65535      # row tiles past it are taken in a grid-stride loop


class RffGeometry(NamedTuple):
    """A launch's tiles: block (c, r) owns the columns [32 c, 32 c + 32)
    and the rows [8 R r, 8 R r + 8 R) of Z, R rows a thread."""
    rows_per_thread: int
    col_tiles: int
    row_tiles: int

    @property
    def grid(self) -> tuple:
        return self.col_tiles, min(self.row_tiles, MAX_GRID_Y)


@_build.compiled_cache
def rff_geometry(M: int, D: int) -> RffGeometry:
    """The least rows a thread that still gives about ``FILL_BLOCKS``
    blocks (at most 8): at D = 2048 (64 column tiles) serving's buckets
    of 16, 32 and 64 rows get 128 blocks each.  Depends on M and D only;
    an element's floats depend on neither."""
    col_tiles = -(-D // RFF_COLS)
    want = -(-FILL_BLOCKS // col_tiles)          # row tiles wanted
    need = -(-M // (RFF_WARPS * want))
    R = next((r for r in ROWS_PER_THREAD if r >= need), ROWS_PER_THREAD[-1])
    return RffGeometry(R, col_tiles, -(-M // (RFF_WARPS * R)))


#: a block's rows (8 R) for each rows a thread R
ROW_BLOCKS = tuple(RFF_WARPS * r for r in ROWS_PER_THREAD)


def _rff_default(dims) -> tuple:
    return RFF_WARPS * rff_geometry(*dims).rows_per_thread, RFF_COLS


def _rff_candidates(dims) -> tuple:
    """Every row block up to the padded extent, M rounded up to the
    default's row block (which is always one): R changes no element's
    floats."""
    step = _rff_default(dims)[0]
    padded = -(-max(dims[0], 1) // step) * step
    return tuple((rows, RFF_COLS) for rows in ROW_BLOCKS if rows <= padded)


def _rff_check(dims, blocks) -> None:
    if len(blocks) != 2 or blocks[0] not in ROW_BLOCKS \
            or blocks[1] != RFF_COLS:
        raise ValueError(f"rff takes (block_m, block_d) with block_m, the "
                         f"rows a block, in {ROW_BLOCKS} and block_d "
                         f"{RFF_COLS} (columns a block), not {blocks}")


autotune.register("rff", default=_rff_default, candidates=_rff_candidates,
                  check=_rff_check)


def rff(X, W, b, *, num_features=None, block_m=None,
        block_d=None) -> torch.Tensor:
    """X (M, d), W (D, d), b (D,) -> Z (M, D) fp32; the scale is
    ``math.sqrt(2 / num_features)`` (default D), a host float.
    ``block_m``: the rows of Z a block owns, 8 R for R rows a thread
    (8, 16, 32 or 64); ``block_d``: its columns (32 only).  None
    resolves through ``autotune.tuned_blocks("rff", (M, D))``."""
    if X.dim() != 2 or W.dim() != 2 or W.shape[1] != X.shape[1] \
            or b.shape != (W.shape[0],):
        raise ValueError(f"rff shapes X {tuple(X.shape)}, W "
                         f"{tuple(W.shape)}, b {tuple(b.shape)}")
    (M, d), D = X.shape, W.shape[0]
    if block_m is None or block_d is None:
        block_m, block_d = autotune.tuned_blocks("rff", (M, D),
                                                 kind=f"d={d}")
    else:
        _rff_check((M, D), (block_m, block_d))
    if X.device.type == "cpu":
        return ref.rff_ref(X, W, b, num_features=num_features)
    if X.device.type != "cuda":
        raise ValueError(f"rff: unsupported device {X.device}")
    _build.check_operands("rff", X.device, X=X, W=W, b=b)
    Z = torch.empty((M, D), dtype=torch.float32, device=X.device)
    if M == 0 or D == 0:
        return Z
    scale = math.sqrt(2.0 / (num_features or D))
    _build.launch(
        "rff", "repro_rff", X.device,
        _build.ptr(X), _build.ptr(W), _build.ptr(b), _build.ptr(Z),
        M, D, d, float(scale), block_m // RFF_WARPS,
        _build.stream_of(X))
    return Z
