"""RG-LRU recurrent block (port of ``repro/models/rglru.py``;
RecurrentGemma / Griffin, arXiv:2402.19427).

Block: two branches from the residual stream --
  gate branch:      y = gelu(W_y x)
  recurrent branch: u = W_x x -> causal conv1d(4) -> RG-LRU -> h
output: W_o (h * y).

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_a u_t + b_a)              recurrence gate
  i_t = sigmoid(W_i u_t + b_i)              input gate
  log_a_t = -c * softplus(Lambda) * r_t     (c = 8)
  a_t = exp(log_a_t)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Training and prefill evaluate the linear recurrence as a log-depth
scan of tensor slices (``_scan``) that follows
``jax.lax.associative_scan``'s own odd/even recursion, so that each
h_t is combined in the reference's order; it runs under autograd, a
few elementwise launches a level.  Decoding is the O(1) step; the
cache is the fixed-size hidden state and conv buffer, whatever the
context length.

The dtypes are the reference's: the gates are sigmoids of the model
dtype's ``dense`` outputs widened to float32, ``h`` is float32, the
product ``h * y`` is rounded to the model's dtype before ``w_o``, and
``Lambda`` is a float32 leaf in a tree of the model's dtype.  GELU is
the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import as_draws, causal_conv1d, conv1d_init, conv1d_step, \
    dense, dense_init, expand_left

Params = Dict[str, torch.Tensor]

_C = 8.0


class LRUState(NamedTuple):
    h: torch.Tensor           # (B, W) hidden state, float32
    conv_buf: torch.Tensor    # (B, conv_width-1, W)


def rglru_init(rng, cfg: ModelConfig, dtype) -> Params:
    """Parameters drawn from ``rng`` on its device; ``Lambda`` so that
    a ~ U[0.9, 0.999] at r = 1 (softplus^-1(-log(u) / c), the Griffin
    init)."""
    rng = as_draws(rng)
    d, W = cfg.d_model, cfg.lru_dim
    k1, k2, k3, k4, k5, k6 = rng.split(6)
    w_y = dense_init(k1, d, W, dtype)
    w_x = dense_init(k2, d, W, dtype)
    conv = conv1d_init(k3, cfg.conv_width, W, dtype)
    w_a = dense_init(k4, W, W, dtype, bias=True)
    w_i = dense_init(k5, W, W, dtype, bias=True)
    u = k6.uniform((W,), 0.9, 0.999)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    return {"w_y": w_y, "w_x": w_x, "conv": conv, "w_a": w_a, "w_i": w_i,
            "Lambda": lam,
            "w_o": dense_init(rng.fold_in(7), W, d, dtype)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(p: Params, u: torch.Tensor):
    """(a, gated input), both float32, for the conv output u."""
    r = torch.sigmoid(dense(p["w_a"], u).float())
    i = torch.sigmoid(dense(p["w_i"], u).float())
    log_a = -_C * expand_left(_softplus(p["Lambda"]), r.dim()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) \
        * (i * u.float())
    return a, gated_in


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (even holds as
    many items as odd, or one more)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).reshape(
        (odd.shape[0], 2 * n) + tuple(odd.shape[2:]))
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], 1)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0: the b part of
    ``lax.associative_scan(combine, (a, b), axis=1)`` with combine((a1,
    b1), (a2, b2)) = (a1 a2, a2 b1 + b2), by its recursion -- pairs
    combined, the odd items scanned on the half-length sequence, the
    even items one combine from them -- so each h_t is the reference's
    sum in the reference's order.  The a part of the result is never
    read (a combine's b needs only the right operand's a), so it is not
    computed."""
    n = a.shape[1]
    if n < 2:
        return b
    a2 = a[:, 1::2]
    odd = _scan(a[:, 0:-1:2] * a2, a2 * b[:, 0:-1:2] + b[:, 1::2])
    left = odd[:, :-1] if n % 2 == 0 else odd
    even = a[:, 2::2] * left + b[:, 2::2]
    return _interleave(torch.cat([b[:, :1], even], dim=1), odd)


def init_lru_state(cfg: ModelConfig, B: int, dtype,
                   device=None) -> LRUState:
    return LRUState(
        h=torch.zeros((B, cfg.lru_dim), dtype=torch.float32, device=device),
        conv_buf=torch.zeros((B, cfg.conv_width - 1, cfg.lru_dim),
                             dtype=dtype, device=device))


def rglru_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  state: Optional[LRUState] = None
                  ) -> Tuple[torch.Tensor, LRUState]:
    """x: (B, S, d) -> (out, new_state); ``state`` carries h and the
    conv buffer in from an earlier chunk."""
    B = x.shape[0]
    y = F.gelu(dense(p["w_y"], x), approximate="tanh")
    ux = dense(p["w_x"], x)
    if state is None:
        state = init_lru_state(cfg, B, x.dtype, x.device)
    u = causal_conv1d(p["conv"], ux, left_context=state.conv_buf)
    new_buf = torch.cat([state.conv_buf, ux], dim=1)[
        :, -(cfg.conv_width - 1):, :]
    a, b = _gates(p, u)                        # (B, S, W) float32
    # fold the initial state into the first step: b_1 += a_1 h0
    b = torch.cat([b[:, :1] + a[:, :1] * state.h[:, None], b[:, 1:]], dim=1)
    h = _scan(a, b)
    out = dense(p["w_o"], (h * y.float()).to(x.dtype))
    return out, LRUState(h=h[:, -1], conv_buf=new_buf)


def rglru_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                 state: LRUState) -> Tuple[torch.Tensor, LRUState]:
    """x_t: (B, 1, d) single-token step."""
    y = F.gelu(dense(p["w_y"], x_t[:, 0]), approximate="tanh")
    ux = dense(p["w_x"], x_t[:, 0])
    buf, u = conv1d_step(p["conv"], state.conv_buf, ux)
    a, b = _gates(p, u)                        # (B, W)
    h = a * state.h + b
    out = dense(p["w_o"], (h * y.float()).to(x_t.dtype))
    return out[:, None, :], LRUState(h=h, conv_buf=buf)
