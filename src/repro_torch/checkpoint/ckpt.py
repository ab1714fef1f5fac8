"""Pytree checkpointing (port of ``repro/checkpoint/ckpt.py``).

Saves and restores pytrees of tensors (parameters, optimizer state, the
protocol state with its reference model) with dtype and shape kept, in
the reference's file format: a msgpack map of ``treedef``, ``leaves``
and ``structure``, each leaf ``{__nd__, dtype, shape, data}`` with
bfloat16 written as the dtype name ``bfloat16`` over its raw 2-byte
words.  Leaves come in ``jax.tree.leaves`` order (dict keys sorted).
``treedef`` holds the port's own description; the reference's
``restore`` reads only the leaves, so a file either package writes
restores in the other.

Layout: one ``step_XXXXXXXX.ckpt`` per step plus a ``latest`` pointer,
each written to a temporary name and renamed into place.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..tree import is_namedtuple, leaves, unflatten
from . import _msgpack as msgpack

PyTree = Any


def _encode_leaf(x) -> dict:
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {b"__nd__": True, b"dtype": b"bfloat16",
                    b"shape": list(t.shape),
                    b"data": t.view(torch.int16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return {b"__nd__": True, b"dtype": arr.dtype.name.encode(),
            b"shape": list(arr.shape), b"data": arr.tobytes()}


def _decode_leaf(obj, device) -> torch.Tensor:
    name = obj[b"dtype"]
    name = name.decode() if isinstance(name, bytes) else name
    shape = list(obj[b"shape"])
    if name == "bfloat16":
        words = np.frombuffer(obj[b"data"], dtype=np.int16).reshape(shape)
        t = torch.from_numpy(words.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(obj[b"data"], dtype=np.dtype(name)).reshape(shape)
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _structure_of(tree: PyTree):
    """Serializable mirror of the pytree with leaves replaced by 0."""
    if isinstance(tree, dict):
        return {k: _structure_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        named = type(tree).__name__ if is_namedtuple(tree) else kind
        return {"__seq__": named, "items": [_structure_of(v) for v in tree]}
    return 0


def _describe(tree: PyTree) -> str:
    """The port's ``treedef``: the structure with ``*`` for a leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        name = type(tree).__name__ if is_namedtuple(tree) else ""
        return f"{name}[{inner}]" if isinstance(tree, list) else f"{name}({inner})"
    return "None" if tree is None else "*"


def save(path: str, tree: PyTree) -> None:
    payload = {
        b"treedef": ("repro_torch " + _describe(tree)).encode(),
        b"leaves": [_encode_leaf(x) for x in leaves(tree)],
        b"structure": _structure_of(tree),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)


def restore(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (shapes checked); each
    leaf goes to the device of ``like``'s leaf (the CPU for a leaf that
    is not a tensor)."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    encoded = payload[b"leaves"]
    like_leaves = leaves(like)
    if len(encoded) != len(like_leaves):
        raise ValueError(
            f"checkpoint has {len(encoded)} leaves, expected {len(like_leaves)}")
    out = []
    for obj, want in zip(encoded, like_leaves):
        is_t = torch.is_tensor(want)
        shape = tuple(want.shape) if is_t else np.shape(want)
        got = _decode_leaf(obj, want.device if is_t else "cpu")
        if tuple(got.shape) != shape:
            raise ValueError(f"shape mismatch: {tuple(got.shape)} vs {shape}")
        out.append(got)
    return unflatten(like, out)


def save_step(ckpt_dir: str, step: int, tree: PyTree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.ckpt")
    save(path, tree)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(os.path.basename(path))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    return path


def latest_step(ckpt_dir: str):
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return os.path.join(ckpt_dir, f.read().strip())
