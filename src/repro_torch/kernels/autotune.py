"""Launch-geometry resolver for the hand-written kernels (port of
``repro/kernels/autotune.py``, DESIGN.md Sec. 12).

``tuned_blocks(op, dims, ...)`` returns the block geometry a kernel
launches with, resolved in three tiers, as the reference's:

1. **cache hit**: a process-local table keyed on
   ``(op, dims, dtype, kind)``.  A hit is one dictionary lookup on a
   plain tuple, so the wrappers resolve on every call at no more host
   cost than the geometry functions' own caches had.
2. **defaults**: off the card, without a ``measure`` thunk, or while a
   CUDA graph is being captured on the current stream (a search
   launches kernels; the reference's ``_tracing()`` guard), the
   default is the kernel module's geometry function
   (``fused.sv_predict_geometry``, ``fused.primal_step_geometry``,
   ``rff.rff_geometry``; the compile-time tiles of ``gram`` and
   ``quadform``), recorded with ``source="default"``.  Nothing is
   launched.
3. **measured search** (the card, a ``measure`` thunk given): each
   candidate is timed with ``telemetry.probe.time_fn`` and the fastest
   is cached with ``source="search"`` and every candidate's time.  The
   wrappers never pass a thunk: a search is asked for explicitly (as
   ``chip_smoke.py`` phase 2 does), so a path's launch counts stay its
   own.

The candidates are the port's geometries, not the TPU's 128/256/512
tiles, and a search picks only among geometries whose outputs are
bitwise the default's: a run is a pure function of its seeds, and a
timing that chose between sum orders could flip a dynamic sync
decision from one process to the next.  ``rff``'s rows a thread change
no element's floats, so it has several candidates; a cluster split of
``sv_predict`` or the RFF step changes the sum order, so each keeps
one; ``gram`` and ``quadform`` have compile-time tiles.  The search
holds every candidate's output to the first one's bitwise and raises
on a miss.  ``pin`` may force any geometry the kernel takes (what-if
timing): that choice is explicit.

A geometry depends on a row's extents (N, d, D), never on the number
of rows (B, P): a batched row stays bitwise ``predict_one``'s.
``rff``'s key holds its row count M, whose tiling changes no float.

Each kernel module registers its op (``register``): the default, the
candidates and the check of an explicit geometry, which raises
``ValueError`` for one the kernel cannot take.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..tree import leaves

_SEARCH_ITERS = 3                 # timed calls per candidate


class TileKey(NamedTuple):
    """Cache key: one geometry per (op, operand extents, dtype, kind).
    Equal to the plain tuple the cache stores."""

    op: str
    dims: Tuple[int, ...]
    dtype: str
    kind: str


class TileChoice(NamedTuple):
    """A resolved geometry, where it came from, and (after a search)
    each candidate's time in ms."""

    blocks: Tuple[int, ...]
    source: str                   # "default" | "search" | "pinned"
    times_ms: Tuple[Tuple[Tuple[int, ...], float], ...] = ()


class _Op(NamedTuple):
    default: Callable[[Tuple[int, ...]], Tuple[int, ...]]
    candidates: Callable[[Tuple[int, ...]], Tuple[Tuple[int, ...], ...]]
    check: Callable[[Tuple[int, ...], Tuple[int, ...]], None]


_OPS: Dict[str, _Op] = {}
_CACHE: Dict[tuple, TileChoice] = {}


def register(op: str, *, default, check, candidates=None) -> None:
    """Declare ``op``'s geometry: ``default(dims)`` and
    ``candidates(dims)`` (default: the default alone) give block tuples,
    ``check(dims, blocks)`` raises ``ValueError`` for one the kernel
    cannot take."""
    _OPS[op] = _Op(default, candidates or (lambda dims: (default(dims),)),
                   check)


def _spec(op: str) -> _Op:
    if op not in _OPS:
        raise ValueError(f"no geometry is registered for op {op!r}; "
                         f"known: {sorted(_OPS)}")
    return _OPS[op]


def _dims(dims: Sequence[int]) -> Tuple[int, ...]:
    return dims if type(dims) is tuple else tuple(int(s) for s in dims)


def candidates_for(op: str, dims: Sequence[int]) -> Tuple[Tuple[int, ...], ...]:
    """The geometries a search may time for ``op`` at ``dims``: each
    bitwise the default's output and none past the padded extent."""
    return _spec(op).candidates(_dims(dims))


def default_blocks(op: str, dims: Sequence[int]) -> Tuple[int, ...]:
    """The no-search choice: the kernel module's geometry function."""
    return _spec(op).default(_dims(dims))


def _same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _search(op: str, key: tuple, measure) -> TileChoice:
    from ..telemetry.probe import time_fn     # telemetry imports kernels

    times, first = [], None
    for blocks in candidates_for(op, key[1]):
        out = measure(blocks)
        if first is None:
            first = out
        elif not _same(out, first):
            raise RuntimeError(f"autotune: {op} at {key[1]} with blocks "
                               f"{blocks} is not bitwise the first "
                               f"candidate's output")
        stats = time_fn(measure, blocks, warmup=1, iters=_SEARCH_ITERS)
        times.append((blocks, stats.us_per_call / 1e3))
    best = min(times, key=lambda bt: bt[1])[0]
    return TileChoice(best, "search", tuple(times))


def tuned_blocks(op: str, dims: Sequence[int], *, dtype: str = "float32",
                 kind: str = "",
                 measure: Optional[Callable[[Tuple[int, ...]], object]] = None,
                 ) -> Tuple[int, ...]:
    """The geometry to launch ``op`` with at operand extents ``dims``.

    ``measure(blocks)`` -- when given and a CUDA card is visible -- must
    run the kernel once with that geometry and return its output (a
    tensor or a tree of them); the resolver times each candidate and
    caches the fastest.  Otherwise, or while the current stream is
    capturing a CUDA graph, the default is cached without any launch.
    """
    key = (op, _dims(dims), dtype, kind)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit.blocks
    if (measure is None or not torch.cuda.is_available()
            or torch.cuda.is_current_stream_capturing()):
        choice = TileChoice(default_blocks(op, key[1]), "default")
    else:
        choice = _search(op, key, measure)
    _CACHE[key] = choice
    return choice.blocks


# -- introspection / test hooks ---------------------------------------------


def pin(op: str, dims: Sequence[int], blocks: Sequence[int], *,
        dtype: str = "float32", kind: str = "") -> None:
    """Force a geometry for one key (what-if timing); raises
    ``ValueError`` if the kernel cannot take it."""
    dims, blocks = _dims(dims), tuple(int(b) for b in blocks)
    _spec(op).check(dims, blocks)
    _CACHE[(op, dims, str(dtype), str(kind))] = TileChoice(blocks, "pinned")


def cache_info() -> Dict[TileKey, TileChoice]:
    """A snapshot of the resolution table (a copy)."""
    return {TileKey(*k): v for k, v in _CACHE.items()}


def clear_cache() -> None:
    _CACHE.clear()
