"""Random Fourier Features learner (port of ``repro/core/rff.py``).

phi(x) = sqrt(2/D) * cos(W x + b),   W ~ N(0, 2*gamma I),  b ~ U[0, 2pi]

A spec without arrays draws (W, b) as the reference does, with JAX's
threefry generator (``prng``): ``split(PRNGKey(seed))``, W from the
first key's normals times the float32 ``sqrt(2 gamma)``, b from the
second key's uniforms on [0, 2 pi), bitwise the reference's on any
device.  A spec may also carry ``W`` and ``b`` as arrays, a draw made
elsewhere (``convert.rff_spec`` hands over the reference's own).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import prng


@dataclasses.dataclass(frozen=True, eq=False)
class RFFSpec:
    """D random features over d inputs; ``W`` (D, d) and ``b`` (D,) as
    arrays or tensors, or None to draw the reference's from ``seed``.
    Compared by identity (it holds arrays)."""

    dim: int                # input dim d
    num_features: int       # D
    gamma: float = 1.0
    seed: int = 0
    W: Optional[object] = None
    b: Optional[object] = None

    def to(self, device) -> "RFFSpec":
        """This spec with (W, b) as float32 tensors on ``device``."""
        W, b = rff_params(self)
        return dataclasses.replace(self, W=W.to(device), b=b.to(device))


def _f32(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(torch.float32)
    return torch.as_tensor(np.array(v, dtype=np.float32))


def rff_params(spec: RFFSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, b) of the spec: its own arrays, or the reference's draw from
    ``seed`` (on the CPU)."""
    if spec.W is not None and spec.b is not None:
        W, b = _f32(spec.W), _f32(spec.b)
        if W.shape != (spec.num_features, spec.dim) or b.shape != (spec.num_features,):
            raise ValueError(
                f"W {tuple(W.shape)} / b {tuple(b.shape)} do not match "
                f"D={spec.num_features}, d={spec.dim}")
        return W, b
    return _draw(spec.dim, spec.num_features, spec.gamma, spec.seed)


@functools.lru_cache(maxsize=16)
def _draw(dim: int, num_features: int, gamma: float, seed: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's (W, b) for these arguments, drawn once (a spec
    without arrays is asked for them every round); read-only."""
    kw, kb = prng.split(prng.PRNGKey(seed))
    # jnp.sqrt(2.0 * gamma): the float32 root of the float32 product
    scale = float(np.sqrt(np.float32(2.0 * gamma)))
    W = prng.normal(kw, (num_features, dim)) * scale
    b = prng.uniform(kb, (num_features,), maxval=2.0 * math.pi)
    return W, b


def feature_scale(num_features: int) -> torch.Tensor:
    """sqrt(2/D) rounded as the reference's ``jnp.sqrt(2.0 / D)``: the
    square root taken in float32."""
    return torch.sqrt(torch.tensor(2.0 / num_features, dtype=torch.float32))


def _sum_last(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v, dim=-1)


def featurize(spec: RFFSpec, W: torch.Tensor, b: torch.Tensor,
              X: torch.Tensor, sum_last=_sum_last) -> torch.Tensor:
    """phi(X): (..., d) -> (..., D), the projection as an explicit
    multiply + last-axis reduce (row results independent of the batch);
    ``sum_last`` is that reduce (the serving face passes a fixed-order
    one)."""
    proj = sum_last(X[..., None, :] * W) + b
    return feature_scale(spec.num_features).to(X.device) * torch.cos(proj)


class RFFLearnerState(NamedTuple):
    w: torch.Tensor   # (..., D) primal weights
    b: torch.Tensor   # (...)


def init_state(spec: RFFSpec, *, lead: Tuple[int, ...] = (),
               device=None) -> RFFLearnerState:
    return RFFLearnerState(
        w=torch.zeros(lead + (spec.num_features,), dtype=torch.float32,
                      device=device),
        b=torch.zeros(lead, dtype=torch.float32, device=device))


def make_update(spec: RFFSpec, W: torch.Tensor, bias: torch.Tensor, *,
                eta: float = 0.5, lam: float = 0.01, loss: str = "hinge"):
    """SGD in the RFF primal space for one learner:
    ``update(state, (x, y)) -> (state, loss)``, an exactly
    loss-proportional convex update on a fixed-size model."""

    def update(state: RFFLearnerState, example):
        x, y = example
        z = featurize(spec, W, bias, x[None])[0]
        yhat = torch.sum(state.w * z) + state.b
        if loss == "hinge":
            ell = torch.clamp(1.0 - y * yhat, min=0.0)
            g = torch.where(ell > 0, -y, torch.zeros_like(y))
        else:
            r = yhat - y
            ell, g = 0.5 * r * r, r
        w = (1.0 - eta * lam) * state.w - eta * g * z
        b = state.b - eta * g
        return RFFLearnerState(w=w, b=b), ell

    return update
