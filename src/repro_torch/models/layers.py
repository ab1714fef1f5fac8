"""Shared neural building blocks (port of ``repro/models/layers.py``).

Plain functions over dictionaries of tensors with the reference's keys
and layouts: a dense weight is ``(d_in, d_out)`` and the layer computes
``x @ w + b``.  Norms and RoPE compute in float32 and return the input
dtype, as the reference's do.

Initializers take an explicit ``torch.Generator`` and draw on its
device.  They follow the reference's scales, not its numbers: JAX's
keys and PyTorch's generators give different draws from the same seed,
so the tests carry the reference's parameters across
(``convert.lm_params``).  ``constrain`` is the identity: the port has
no GSPMD to take a sharding constraint.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def expand_left(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A parameter with ``ndim - 1`` leading size-1 axes, so that its
    broadcast against a rank-``ndim`` activation is explicit, as the
    reference's."""
    return v.reshape((1,) * (ndim - 1) + tuple(v.shape))


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """The identity.  The reference's ``constrain``
    (``src/repro/models/layers.py:25``) pins a GSPMD sharding when it
    traces under a mesh and is a no-op on one device; the port runs one
    card a model and has no GSPMD, so ``spec`` is ignored."""
    del spec
    return x


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def norm_init(kind: str, d: int, dtype, device=None) -> Params:
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def norm_apply(kind: str, p: Params, x: torch.Tensor,
               eps: float) -> torch.Tensor:
    return rmsnorm(p, x, eps) if kind == "rmsnorm" else layernorm(p, x, eps)


# ---------------------------------------------------------------------------
# Dense / embeddings
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               bias: bool = False, scale: Optional[float] = None) -> Params:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": (_randn(gen, d_in, d_out) * s).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": (_randn(gen, vocab, d) * 0.02).to(dtype)}


class _Embedding(torch.autograd.Function):
    """A row lookup whose backward sums each row's gradients by a
    one-hot product (a GEMM), not a scatter: deterministic on the card
    with deterministic algorithms on, whatever the token counts."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        return F.embedding(tokens, table)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        rows = torch.arange(ctx.vocab, device=flat.device)
        onehot = (rows[:, None] == flat[None, :]).to(g.dtype)
        return onehot @ g.reshape(-1, g.shape[-1]), None


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return _Embedding.apply(p["table"], tokens)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): the rotary half-dims are split into
    (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions3: (3, B, S); sum(sections) == hd // 2.
    Half-dim i takes the stream of the section it falls in, as the
    reference's ``repeat`` / ``take`` selects it.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"hd // 2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    lead = tuple(positions3.shape[1:])
    pos = torch.cat([positions3[i][..., None].expand(lead + (n,))
                     for i, n in enumerate(sections)], dim=-1)  # (B, S, hd/2)
    angles = (pos.float() * freqs)[..., None, :]              # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d: int, dtype, device=None) -> torch.Tensor:
    """(seq_len, d) ``[sin, cos]`` of pos / 10000^(2 i / d), i < d / 2:
    the angles in float32 from integer positions, as the reference's
    (its CPU ``sin`` / ``cos`` are XLA's, so the two agree to a few
    float32 ulps, not bitwise)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / (10_000.0 ** (2 * i / d))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
             act: str = "silu_glu") -> Params:
    if act == "silu_glu":
        return {"wi": dense_init(gen, d, d_ff, dtype),
                "wg": dense_init(gen, d, d_ff, dtype),
                "wo": dense_init(gen, d_ff, d, dtype)}
    return {"wi": dense_init(gen, d, d_ff, dtype, bias=True),
            "wo": dense_init(gen, d_ff, d, dtype, bias=True)}


def mlp(p: Params, x: torch.Tensor, act: str = "silu_glu") -> torch.Tensor:
    if act == "silu_glu":
        h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(p["wi"], x), approximate="tanh")
    return dense(p["wo"], h)


# ---------------------------------------------------------------------------
# Conv1d (causal, depthwise): the Mamba-2 frontend
# ---------------------------------------------------------------------------


def conv1d_init(gen: torch.Generator, width: int, channels: int,
                dtype) -> Params:
    return {"w": (_randn(gen, width, channels) / math.sqrt(width)).to(dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=gen.device)}


def causal_conv1d(p: Params, x: torch.Tensor,
                  left_context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, C) depthwise causal conv.  ``left_context``: (B,
    width-1, C) preceding inputs (zeros if None), for exact chunked
    prefill.  The ``width`` shifted products are summed in x's dtype in
    the order i = 0 .. width-1 and the bias added last, each operation
    rounded to that dtype: the reference's ``sum(...)`` bitwise in
    bf16."""
    width, S = p["w"].shape[0], x.shape[1]
    if left_context is None:
        pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        pad = torch.cat([left_context.to(x.dtype), x], dim=1)
    out = pad[:, 0:S, :] * p["w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + S, :] * p["w"][i]
    return out + p["b"]


def conv1d_step(p: Params, buf: torch.Tensor,
                x_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  buf: (B, width-1, C) past inputs; returns
    (the new buffer, (B, C)).  The reference's einsum over the window:
    the products summed in float32 in window order, rounded once to the
    dtype, then the bias added (bitwise in bf16)."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)       # (B, width, C)
    w = p["w"].float()
    acc = window[:, 0, :].float() * w[0]
    for i in range(1, w.shape[0]):
        acc = acc + window[:, i, :].float() * w[i]
    return window[:, 1:, :], acc.to(x_t.dtype) + p["b"]
