"""Carry state across from the reference's arrays, and back to numpy.

The port imports nothing of the JAX package, so these functions take
anything array-like with the reference's field names (its NamedTuples
hold JAX arrays, which ``np.asarray`` reads) and build the port's
NamedTuples of tensors on ``device``: floats as float32, ids and
counters as int32, exactly as the reference stores them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.learners import KernelLearnerState, LinearLearnerState
from .core.rff import RFFLearnerState, RFFSpec
from .core.rkhs import SVModel


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, dtype=np.float32), device=device)


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.array(v, dtype=np.int32), device=device)


def sv_model(model: Any, device=None) -> SVModel:
    """An (optionally stacked) ``SVModel`` from (sv, alpha, sv_id)."""
    return SVModel(sv=_f32(model.sv, device), alpha=_f32(model.alpha, device),
                   sv_id=_i32(model.sv_id, device))


def kernel_learner_state(state: Any, device=None) -> KernelLearnerState:
    """A (stacked) ``KernelLearnerState`` from (model, counter, learner_id)."""
    return KernelLearnerState(model=sv_model(state.model, device),
                              counter=_i32(state.counter, device),
                              learner_id=_i32(state.learner_id, device))


def linear_state(state: Any, device=None) -> LinearLearnerState:
    return LinearLearnerState(w=_f32(state.w, device), b=_f32(state.b, device))


def rff_state(state: Any, device=None) -> RFFLearnerState:
    return RFFLearnerState(w=_f32(state.w, device), b=_f32(state.b, device))


def rff_spec(spec: Any, W, b) -> RFFSpec:
    """The port's ``RFFSpec`` for a reference spec (dim, num_features,
    gamma, seed) with the reference's own draw ``(W, b)``."""
    return RFFSpec(dim=int(spec.dim), num_features=int(spec.num_features),
                   gamma=float(spec.gamma), seed=int(spec.seed),
                   W=np.asarray(W, dtype=np.float32),
                   b=np.asarray(b, dtype=np.float32))


def to_numpy(tree: Any):
    """A NamedTuple of tensors (nested) as the same NamedTuple of numpy
    arrays; a lone tensor as an array."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
