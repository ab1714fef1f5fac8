"""Sharding rules: parameter and cache trees -> partition-spec trees
(port of ``repro/launch/sharding.py``).

The scheme is the reference's (DESIGN.md Sec. 5):

- tensor-parallel over the ``model`` axis on merged head dims, FFN
  hidden dims, expert dims and the padded vocab;
- the protocol's learner axis (the leading dim of the stacked training
  state) over the data axes ``("pod", "data")``;
- replication for any dim the model-axis size does not divide (checked
  leaf by leaf, never an invalid spec);
- caches: the batch dim over the data axes when they divide it, a long
  context dim over ``model``.

PyTorch has no ``PartitionSpec``: a spec here is a :class:`PSpec`, a
tuple with the reference's entries (``None``, an axis name, or a tuple
of axis names), one a dim, so a test compares the two entry by entry.
The port runs one process, so a spec does not place anything: the dry
run (``launch/dryrun.py``) reads the per-device shapes and bytes it
implies (``per_device_shape``, ``per_device_bytes``).

The rules match the end of a leaf's path and govern its trailing dims,
so they carry over although the port's trees are laid out otherwise:
the reference stacks each stage's units (``stages/<s>/b<j>/...``, a
leading repeat dim on every leaf), the port keeps one dict a layer
(``layers/<i>/...``, no repeat dim).  Leading dims the rule does not
govern are replicated, or carry the learner axes.

Caches: a port cache leaf is one layer's, batch first; the reference's
are stacked ``(repeats, B, L, ...)``.  So where the reference reads dim
1 as the batch and dim 2 as the context length, the port reads dims 0
and 1 of its own layout (``cache_pspec``).  The second dim is an
attention cache's context length; for the RG-LRU state ``h`` (B, W) it
is the recurrence width, which the reference's rule shards over
``model`` too when it reaches ``seq_min`` (recurrentgemma_9b's 4096).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Optional, Tuple

import torch

from ..tree import is_namedtuple, leaves

PyTree = Any

# (path regex, spec for trailing dims).  "M" marks the model axis; the
# number of entries fixes how many trailing dims the rule governs.
_PARAM_RULES = [
    (r"embed/table$",        ("M", None)),
    (r"dec_pos/table$",      (None, None)),
    (r"lm_head/w$",          (None, "M")),
    (r"lm_head/b$",          ("M",)),
    (r"(wq|wk|wv)/w$",       (None, "M")),
    (r"(wq|wk|wv)/b$",       ("M",)),
    (r"wo/w$",               ("M", None)),
    (r"wo/b$",               (None,)),
    (r"mlp/(wi|wg)/w$",      (None, "M")),
    (r"mlp/(wi|wg)/b$",      ("M",)),
    (r"mlp/wo/w$",           ("M", None)),
    (r"mlp/wo/b$",           (None,)),
    (r"moe/router/w$",       (None, None)),
    (r"moe/(wi|wg)$",        ("M", None, None)),   # expert-parallel
    (r"moe/wo$",             ("M", None, None)),
    (r"ssm/in_proj/w$",      (None, None)),        # mixed concat out-dim
    (r"ssm/out_proj/w$",     ("M", None)),
    (r"rglru/(w_y|w_x)/w$",  (None, "M")),
    (r"rglru/(w_a|w_i)/w$",  ("M", "M_diag")),     # see _fix_special
    (r"rglru/(w_a|w_i)/b$",  ("M",)),
    (r"rglru/w_o/w$",        ("M", None)),
    (r"rglru/Lambda$",       ("M",)),
    (r"mla_?.*w_dq/w$",      (None, None)),
    (r"w_dq/w$",             (None, None)),
    (r"w_uq/w$",             (None, "M")),
    (r"w_dkv/w$",            (None, None)),
    (r"w_kr/w$",             (None, None)),
    (r"(w_uk|w_uv)/w$",      (None, "M")),
]


class PSpec(tuple):
    """A partition spec: one entry a dim, ``None`` (replicated), a mesh
    axis name, or a tuple of axis names (the dim split over their
    product).  Dims past the last entry are replicated.  A tuple, so
    frozen and comparable entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PSpec{tuple(self)!r}"


def _fix_special(spec):
    """rglru gate matrices are (W, W); sharding both dims over the same
    axis is invalid: shard rows only."""
    return tuple(None if s == "M_diag" else s for s in spec)


def _apply_rule(spec_tail, shape, model_size: int):
    """Validate divisibility; replicate dims that don't divide."""
    return tuple("model" if s == "M" and dim % model_size == 0
                 and dim >= model_size else None
                 for s, dim in zip(spec_tail, shape))


def _axis_entry(axes: Tuple[str, ...]):
    """One axis as its name, several as their tuple."""
    return axes if len(axes) > 1 else axes[0]


def _map_leaves(fn: Callable, tree: PyTree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree's tensors (dicts, lists, tuples and
    NamedTuples walked; a NamedTuple's path names its fields)."""
    if torch.is_tensor(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(_map_leaves(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"a leaf of type {type(tree).__name__} at "
                    f"{'/'.join(path)}")


def param_pspec(params: PyTree, model_size: int,
                learner_axes: Optional[Tuple[str, ...]] = None) -> PyTree:
    """The :class:`PSpec` tree of a (learner-stacked) parameter tree.

    learner_axes: if given, every leaf carries a leading learner dim
    sharded over these mesh axes."""
    lead = (_axis_entry(learner_axes),) if learner_axes else ()

    def spec_for(path, leaf):
        ps = "/".join(path)
        body = tuple(leaf.shape[len(lead):])
        tail = (None,) * len(body)
        for pat, spec in _PARAM_RULES:
            if re.search(pat, ps):
                spec = _fix_special(spec)
                if len(spec) <= len(body):
                    cut = len(body) - len(spec)
                    tail = (None,) * cut + _apply_rule(spec, body[cut:],
                                                       model_size)
                break
        return PSpec(*lead, *tail)

    return _map_leaves(spec_for, params)


def cache_pspec(caches: PyTree, batch_axes: Tuple[str, ...], batch: int,
                n_batch_axes_size: int, model_size: int = 0,
                seq_min: int = 4096) -> PyTree:
    """Shard cache batch dims over the data axes, and long context dims
    over the model axis (flash-decoding style: the keys are partitioned,
    the softmax and contraction reductions become small all-reduces,
    and the O(B L) cache reads stay local).

    A cache leaf is one layer's, batch first: dim 0 is the batch when
    its size equals ``batch`` and the data axes divide it, dim 1 the
    context length when it is at least ``seq_min`` and the model axis
    divides it (see the module docstring)."""
    ax = _axis_entry(batch_axes)

    def spec_for(_, leaf):
        shape = leaf.shape
        spec = [None] * len(shape)
        if (len(shape) >= 1 and shape[0] == batch
                and batch % n_batch_axes_size == 0):
            spec[0] = ax
        if (model_size and len(shape) >= 2 and shape[1] >= seq_min
                and shape[1] % model_size == 0):
            spec[1] = "model"
        return PSpec(*spec)

    return _map_leaves(spec_for, caches)


def batch_pspec(batch: PyTree, learner_axes: Tuple[str, ...]) -> PyTree:
    """Training batches are (m, b, ...): the learner dim over the data
    axes."""
    ax = _axis_entry(learner_axes)
    return _map_leaves(lambda _, leaf: PSpec(ax, *(None,) * (leaf.dim() - 1)),
                       batch)


def stream_pspec(learner_axes: Tuple[str, ...]) -> PSpec:
    """Protocol streams are (T, m, ...): the round dim replicated, the
    learner dim (axis 1) over the learner axes, feature dims local."""
    return PSpec(None, _axis_entry(learner_axes))


# ---------------------------------------------------------------------------
# Specs on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec paired with the mesh whose axes it names."""

    mesh: Any
    spec: PSpec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return per_device_shape(shape, self.spec, self.mesh)


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _check_axes(spec: PSpec, mesh) -> None:
    """Every axis ``spec`` names is the mesh's, and named once."""
    seen = set()
    for entry in spec:
        for a in _spec_axes(entry):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec}: no axis {a!r} in mesh "
                                 f"{tuple(mesh.axis_names)}")
            if a in seen:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            seen.add(a)


def per_device_shape(shape, spec: PSpec, mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` laid out by ``spec`` on
    ``mesh``: each dim divided by the product of its axes' sizes.
    Raises where an axis is not the mesh's, is named twice, or does not
    divide its dim."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)} has dims")
    _check_axes(spec, mesh)
    out = []
    for i, dim in enumerate(shape):
        axes = _spec_axes(spec[i]) if i < len(spec) else ()
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"spec {spec}: {n} shards do not divide dim "
                             f"{i} of {tuple(shape)}")
        out.append(dim // n)
    return tuple(out)


def _map_specs(fn: Callable, pspecs: PyTree, tree: PyTree = None):
    """``fn(spec, leaf)`` over a spec tree (a :class:`PSpec` is a leaf),
    ``leaf`` the tensor of ``tree`` at the same place, or None without
    a ``tree``.  Raises where ``tree``'s structure is not the specs'."""
    if isinstance(pspecs, PSpec):
        if tree is not None and not torch.is_tensor(tree):
            raise TypeError(f"a leaf of type {type(tree).__name__} "
                            f"against {pspecs!r}")
        return fn(pspecs, tree)
    if torch.is_tensor(tree):
        raise TypeError(f"a tensor of shape {tuple(tree.shape)} against "
                        f"{pspecs!r}, not a PSpec")
    if isinstance(pspecs, dict):
        if tree is not None and set(tree) != set(pspecs):
            raise ValueError(f"keys {sorted(tree)} against {sorted(pspecs)}")
        return {k: _map_specs(fn, v, None if tree is None else tree[k])
                for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        subs = (None,) * len(pspecs) if tree is None else tree
        if len(subs) != len(pspecs):
            raise ValueError(f"{len(subs)} entries against {len(pspecs)} "
                             f"specs")
        out = (_map_specs(fn, v, t) for v, t in zip(pspecs, subs))
        return (type(pspecs)(*out) if is_namedtuple(pspecs)
                else type(pspecs)(out))
    raise TypeError(f"a spec leaf of type {type(pspecs).__name__}")


def to_shardings(mesh, pspecs: PyTree, tree: PyTree = None) -> PyTree:
    """Each spec of ``pspecs`` paired with ``mesh`` as a
    :class:`NamedSharding`.  Every named axis must be the mesh's; with
    ``tree`` (the tensors the specs lay out) each spec must also fit its
    tensor's dims and its axes divide them."""
    def pair(spec, leaf):
        _check_axes(spec, mesh)
        if leaf is not None:
            per_device_shape(leaf.shape, spec, mesh)
        return NamedSharding(mesh, spec)

    return _map_specs(pair, pspecs, tree)


def per_device_bytes(tree: PyTree, pspecs: PyTree, mesh) -> int:
    """The bytes one device holds of ``tree`` laid out by ``pspecs`` on
    ``mesh`` (every shard the same size: the specs divide evenly)."""
    return sum(leaves(_map_specs(
        lambda spec, leaf: math.prod(per_device_shape(leaf.shape, spec, mesh))
        * leaf.element_size(), pspecs, tree)))
