"""Mixture-of-Experts block (port of ``repro/models/moe.py``): top-k
routing over stacked experts, with a fixed capacity per expert.

Parameters: ``router`` (a dense d -> E), and the stacked expert weights
``wi`` / ``wg`` (E, d, expert_ff) and ``wo`` (E, expert_ff, d), the
reference's keys and layouts.

Four forms, as the reference's:
  moe_forward          -- the grouped production path: tokens in groups
                          of ``moe_group_size`` (the last one padded),
                          capacity C_g a group, one-hot dispatch and
                          combine einsums in the input dtype
  moe_forward_einsum   -- the semantic oracle: one group of all T tokens,
                          float32 dispatch and combine
  moe_forward_scatter  -- the same routing, tokens written into (E, C, d)
                          capacity buffers and read back
  moe_forward_dense    -- every expert on every token, combined with the
                          sparse top-k gates; no capacity, nothing
                          dropped (the decode path)
Each returns (out (B, S, d) in x's dtype, aux loss float32 (0 for the
dense form)).

Routing is the reference's, integer for integer:
- ``_top_k`` picks the K largest router probabilities with the lower
  expert index first among equal ones, as ``jax.lax.top_k`` does (bf16
  logits over 64 experts tie often); ``torch.topk`` promises no order
  for ties, so the port takes the first K of a stable descending sort;
- an assignment's position in its expert's capacity counts the earlier
  assignments to that expert in flat (token, k)-major order, per group:
  the reference's stable-argsort rank, computed as an exclusive cumsum
  of the one-hot choices;
- an assignment at a position >= the capacity is dropped (its gate is
  0).

No scatter whose result depends on write order, so forward and backward
are deterministic on the card: one-hots are comparisons against an
``arange``, gate values a one-hot select of the probabilities (exact:
one term is not zero), the dense form's (T, E) gates the same select;
``moe_forward_scatter`` writes only the kept assignments, each to its
own slot, and reads dropped ones as a zero row.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _randn, dense, dense_init

Params = Dict[str, torch.Tensor]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, dff, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    return {
        "router": dense_init(gen, d, E, dtype),
        "wi": (_randn(gen, E, d, dff) / math.sqrt(d)).to(dtype),
        "wg": (_randn(gen, E, d, dff) / math.sqrt(d)).to(dtype),
        "wo": (_randn(gen, E, dff, d) / math.sqrt(dff)).to(dtype),
    }


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(cap, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(..., n) one-hot of ``idx`` by comparison with an ``arange``: no
    scatter, and no read back of ``idx`` (``F.one_hot`` checks its
    range on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, the
    lower index first among equal ones (``jax.lax.top_k``'s order).  The
    values are a one-hot select of ``probs``, so their gradient is an
    elementwise select too."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = (_one_hot(idx, probs.shape[-1], probs.dtype)
            * probs[..., None, :]).sum(dim=-1)
    return vals, idx


def _router(cfg: ModelConfig, p: Params, xt: torch.Tensor):
    logits = dense(p["router"], xt).float()                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, cfg.top_k)         # (T, K)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)       # renormalize
    return logits, probs, gate_vals, expert_idx


def _aux_loss(cfg: ModelConfig, logits, probs, expert_idx) -> torch.Tensor:
    """Switch load-balance loss E sum_e f_e P_e (f_e: the share of
    tokens whose first choice is e) plus 1e-3 of the router z-loss,
    times ``router_aux_coef``."""
    E = cfg.n_experts
    assign_frac = torch.mean(_one_hot(expert_idx[:, 0], E, torch.float32),
                             dim=0)
    router_prob = torch.mean(probs, dim=0)
    lb_loss = E * torch.sum(assign_frac * router_prob)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return cfg.router_aux_coef * (lb_loss + 1e-3 * z_loss)


def _positions(flat_expert: torch.Tensor, E: int) -> torch.Tensor:
    """(..., n) rank of each assignment within its expert, in flat order
    along the last axis: the reference's ``_positions_by_argsort``
    (stable), as the count of earlier equal entries."""
    oh = _one_hot(flat_expert, E, torch.int32)               # (..., n, E)
    before = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh
    return (before * oh).sum(dim=-1, dtype=torch.int32)


def _experts(p: Params, xin: torch.Tensor, lead: str) -> torch.Tensor:
    """The expert MLPs over per-expert rows: xin (``lead`` e c d) ->
    (``lead`` e c d)."""
    h = F.silu(torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, p["wg"])) \
        * torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, p["wi"])
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, p["wo"])


def moe_forward_einsum(cfg: ModelConfig, p: Params,
                       x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh-TF one-hot dispatch over one group of all T tokens (the
    reference's oracle): capacity ``_capacity(T)``, float32 (T, E, C)
    dispatch and combine tensors."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    logits, probs, gate_vals, expert_idx = _router(cfg, p, xt)
    C = _capacity(T, cfg)
    pos = _positions(expert_idx.reshape(T * K), E).reshape(T, K)
    keep = pos < C
    e_oh = _one_hot(expert_idx, E, torch.float32)            # (T, K, E)
    c_oh = _one_hot(torch.where(keep, pos, torch.zeros_like(pos)), C,
                    torch.float32)                           # (T, K, C)
    disp = (e_oh[..., None] * c_oh[:, :, None, :]
            * keep[..., None, None]).sum(dim=1)              # (T, E, C)
    comb = (e_oh[..., None] * c_oh[:, :, None, :]
            * (gate_vals * keep)[..., None, None]).sum(dim=1)
    xin = torch.einsum("td,tec->ecd", xt.float(), disp).to(x.dtype)
    eout = _experts(p, xin, "")                              # (E, C, d)
    out = torch.einsum("ecd,tec->td", eout.float(), comb)
    aux = _aux_loss(cfg, logits, probs, expert_idx)
    return out.reshape(B, S, d).to(x.dtype), aux


def moe_forward_dense(cfg: ModelConfig, p: Params,
                      x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, combined in float32 with the (T, E)
    gates, zero off the top k: exact, no token dropped (the decode
    path; E / K times the routed path's expert products)."""
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, d)
    _, _, gate_vals, expert_idx = _router(cfg, p, xt)
    gates = (_one_hot(expert_idx, E, torch.float32)
             * gate_vals[..., None]).sum(dim=1)              # (T, E)
    h = F.silu(torch.einsum("td,edf->etf", xt, p["wg"])) \
        * torch.einsum("td,edf->etf", xt, p["wi"])
    eout = torch.einsum("etf,efd->etd", h, p["wo"])          # (E, T, d)
    out = torch.einsum("etd,te->td", eout.float(), gates)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return out.reshape(B, S, d).to(x.dtype), aux


def moe_forward_scatter(cfg: ModelConfig, p: Params,
                        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The einsum oracle's routing with O(T K d) data movement: each kept
    assignment's token row written into its (expert, position) slot of
    (E C, d) buffers, the expert outputs read back per assignment and
    summed over k in float32 with the gates.  A dropped assignment
    writes nothing and reads a zero row (the reference's sentinel row,
    without a shared write)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    logits, probs, gate_vals, expert_idx = _router(cfg, p, xt)
    C = _capacity(T, cfg)
    flat_expert = expert_idx.reshape(T * K)
    pos = _positions(flat_expert, E)
    keep = pos < C
    dest = torch.where(keep, flat_expert * C + pos,
                       torch.full_like(pos, E * C))          # E C: dropped
    tok_of = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = torch.zeros((E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest[keep],), xt[tok_of[keep]])
    eout = _experts(p, buf.reshape(E, C, d), "")
    flat_out = torch.cat([eout.reshape(E * C, d),
                          torch.zeros((1, d), dtype=eout.dtype,
                                      device=x.device)])
    per_assign = flat_out[dest]                              # (T K, d)
    w = (gate_vals.reshape(T * K) * keep).float()
    out = (per_assign.float() * w[:, None]).reshape(T, K, d).sum(dim=1)
    aux = _aux_loss(cfg, logits, probs, expert_idx)
    return out.reshape(B, S, d).to(x.dtype), aux


def route_grouped(cfg: ModelConfig, p: Params, xt: torch.Tensor, T: int):
    """The grouped path's routing over ``xt`` (Tp, d), Tp a multiple of
    the group size G, rows T and on padding: (logits, probs, gates
    (Tp, K) zero on padding, expert_idx (Tp, K), positions (g, G, K),
    keep (g, G, K), G, C_g)."""
    E, K = cfg.n_experts, cfg.top_k
    Tp = xt.shape[0]
    G = min(cfg.moe_group_size, T)
    g = Tp // G
    logits, probs, gate_vals, expert_idx = _router(cfg, p, xt)
    if Tp > T:   # padded tokens get zero gates
        gate_vals = gate_vals * (torch.arange(Tp, device=xt.device)
                                 < T)[:, None]
    Cg = max(int(math.ceil(G * K / E * cfg.capacity_factor)), K)
    pos = _positions(expert_idx.reshape(g, G * K), E).reshape(g, G, K)
    return logits, probs, gate_vals, expert_idx, pos, pos < Cg, G, Cg


def moe_forward(cfg: ModelConfig, p: Params,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped one-hot dispatch, the production path: T tokens padded
    with zero rows to a multiple of G = min(moe_group_size, T), capacity
    C_g = max(ceil(G K / E capacity_factor), K) a group and expert.
    Dispatch and combine are (g, G, E, C_g) one-hot einsums in x's dtype
    (the gates rounded to it first), as the reference's; padded rows
    take positions and count in the aux loss's means.  With G >= T it
    is the einsum oracle's routing."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = min(cfg.moe_group_size, T)
    pad = (G - T % G) % G
    xt = x.reshape(T, d)
    if pad:
        xt = torch.cat([xt, torch.zeros((pad, d), dtype=x.dtype,
                                        device=x.device)])
    Tp = T + pad
    g = Tp // G
    logits, probs, gate_vals, expert_idx, pos, keep, G, Cg = route_grouped(
        cfg, p, xt, T)
    ei = expert_idx.reshape(g, G, K)
    gv = gate_vals.reshape(g, G, K)
    e_oh = _one_hot(ei, E, x.dtype)                          # (g, G, K, E)
    c_oh = _one_hot(torch.where(keep, pos, torch.zeros_like(pos)), Cg,
                    x.dtype)                                 # (g, G, K, Cg)
    disp = torch.einsum("gtke,gtkc->gtec", e_oh * keep[..., None], c_oh)
    comb = torch.einsum("gtke,gtkc->gtec",
                        e_oh * (gv * keep).to(x.dtype)[..., None], c_oh)
    xin = torch.einsum("gtd,gtec->gecd", xt.reshape(g, G, d), disp)
    eout = _experts(p, xin, "g")                             # (g, E, Cg, d)
    out = torch.einsum("gecd,gtec->gtd", eout, comb)
    out = out.reshape(Tp, d)[:T]
    aux = _aux_loss(cfg, logits, probs, expert_idx)
    return out.reshape(B, S, d).to(x.dtype), aux
