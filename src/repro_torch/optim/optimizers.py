"""Optimizers (port of ``repro/optim/optimizers.py``): functional, over
one learner's pytree of tensors.

``sgd`` (plain or momentum) is the theory-relevant optimizer: its
update is loss-proportional in the paper's sense (Cor. 8), so the
dynamic protocol's guarantees apply.  ``adamw`` is the practical LM
optimizer.  Updates are computed in float32 and cast back to each
parameter's dtype; optimizer state is float32.  No update writes in
place: the caller keeps the state it passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "sgd"          # sgd | adamw
    lr: float = 1e-2
    momentum: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0     # 0 = off


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, torch.Tensor], Tuple[PyTree, PyTree]]
    # update(grads, opt_state, params, step) -> (new_params, new_state)


def _clip(grads: PyTree, max_norm: float) -> PyTree:
    """Scale one learner's gradients to a global float32 norm of at most
    ``max_norm`` (0: off)."""
    if max_norm <= 0:
        return grads
    gn = torch.sqrt(sum(torch.sum(_square32(g)) for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def _square32(g: torch.Tensor) -> torch.Tensor:
    """g * g in float32, in a buffer of its own."""
    d = g.to(torch.float32, copy=True)
    return d.mul_(d)


def _zeros32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def make(cfg: OptimizerConfig) -> Optimizer:
    if cfg.kind == "sgd":
        def init(params):
            return () if cfg.momentum == 0.0 else _zeros32(params)

        def update(grads, state, params, step):
            grads = _clip(grads, cfg.grad_clip)
            # float32 p - lr g (p widened inside the subtraction), cast back
            if cfg.momentum == 0.0:
                new_params = tree_map(
                    lambda p, g: torch.sub(
                        p, g.to(torch.float32, copy=True).mul_(cfg.lr)
                    ).to(p.dtype), params, grads)
                return new_params, state
            new_state = tree_map(lambda m, g: (m * cfg.momentum).add_(g),
                                 state, grads)
            new_params = tree_map(
                lambda p, m: torch.sub(p, m * cfg.lr).to(p.dtype),
                params, new_state)
            return new_params, new_state

        return Optimizer(init=init, update=update)

    if cfg.kind == "adamw":
        def init(params):
            return {"m": _zeros32(params), "v": _zeros32(params)}

        def update(grads, state, params, step):
            grads = _clip(grads, cfg.grad_clip)
            t = step.float() + 1.0
            b1, b2 = cfg.beta1, cfg.beta2
            m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                         state["m"], grads)
            v = tree_map(lambda v, g: b2 * v + (1 - b2) * _square32(g),
                         state["v"], grads)
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t

            def upd(p, m_, v_):
                step_ = cfg.lr * (m_ / c1) / (torch.sqrt(v_ / c2) + cfg.eps)
                if cfg.weight_decay:
                    step_ = step_ + cfg.lr * cfg.weight_decay * p.float()
                return (p.float() - step_).to(p.dtype)

            return tree_map(upd, params, m, v), {"m": m, "v": v}

        return Optimizer(init=init, update=update)

    raise ValueError(cfg.kind)
