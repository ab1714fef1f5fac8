"""Mamba-2 block with the SSD (state-space duality) algorithm (port of
``repro/models/ssm.py``).

Training and prefill use the chunked SSD form (arXiv:2405.21060): the
sequence is split into chunks of length Q; within a chunk the output is
a masked-decay (Q x Q) product, across chunks a recurrent state of
shape (heads, head_dim, d_state) is carried by a loop over the S/Q
chunks (the reference's ``lax.scan``).  Decoding is the O(1) recurrent
step: the cache is the fixed-size state, whatever the context length.

The dtypes are the reference's: ``dt`` goes through softplus in
float32 with the float32 ``dt_bias``; x, B and C are widened to
float32 for the scan and the state ``h`` stays float32; y is rounded
back to the model's dtype before the gate ``y * silu(z)`` and the
gated rmsnorm.  ``A_log``, ``D`` and ``dt_bias`` are float32 leaves in
a tree of the model's dtype.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import xla_math
from .config import ModelConfig
from .layers import as_draws, causal_conv1d, conv1d_init, conv1d_step, \
    dense, dense_init, rmsnorm

Params = Dict[str, torch.Tensor]


class SSMState(NamedTuple):
    h: torch.Tensor          # (B, H, hd, N) recurrent state, float32
    conv_buf: torch.Tensor   # (B, conv_width-1, din + 2*G*N)


# ---------------------------------------------------------------------------
# The deterministic leaves
# ---------------------------------------------------------------------------


def _linspace_1_16(n: int) -> np.ndarray:
    """``jnp.linspace(1.0, 16.0, n)`` as XLA's CPU backend computes it:
    the division by n - 1 turned into a product by the float32
    reciprocal, ``16 * step`` folded into one constant, the last
    product and sum fused (one rounding), the end point appended.
    Equal to it bitwise at every n tests/test_torch_ssm.py checks (1 to
    40 and six larger, up to 352); the configs' head counts are 16 and
    24."""
    f32 = np.float32
    if n == 1:
        return np.ones(1, f32)
    c = f32(1.0) / f32(n - 1)
    i = np.arange(n - 1, dtype=f32)
    head = f32(1.0) - i * c
    out = _fma(i, f32(16.0) * c, head)
    return np.concatenate([out, np.array([16.0], f32)])


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (``xla_math.fma``)."""
    return xla_math.fma(*(torch.as_tensor(np.asarray(v, np.float32))
                          for v in (a, b, c))).numpy()


def _log_f32(x: np.ndarray) -> np.ndarray:
    """``jnp.log`` of positive normal float32 values as XLA's CPU backend
    computes it (``xla_math.log``), so ``A_log`` comes out bitwise the
    reference's (tests/test_torch_ssm.py checks 2e5 values)."""
    x = np.asarray(x, np.float32)
    assert np.all(x >= np.finfo(np.float32).tiny) and np.all(np.isfinite(x))
    return xla_math.log(torch.from_numpy(x.copy())).numpy()


def a_log_init(H: int) -> np.ndarray:
    """``A_log = log(linspace(1, 16, H))`` in float32, the reference's
    bits (host-side, so every device gets the same values)."""
    return _log_f32(_linspace_1_16(H))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def ssm_init(rng, cfg: ModelConfig, dtype) -> Params:
    rng = as_draws(rng)
    d, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    dev = rng.device
    f32 = torch.float32
    k1, k2, k3, _ = rng.split(4)
    return {
        "in_proj": dense_init(k1, d, 2 * din + 2 * G * N + H, dtype),
        "conv": conv1d_init(k2, cfg.ssm_conv, din + 2 * G * N, dtype),
        "A_log": torch.as_tensor(a_log_init(H), device=dev),
        "D": torch.ones((H,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "out_norm": {"scale": torch.ones((din,), dtype=dtype, device=dev)},
        "out_proj": dense_init(k3, din, d, dtype),
    }


def init_ssm_state(cfg: ModelConfig, B: int, dtype, device=None) -> SSMState:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMState(
        h=torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device),
        conv_buf=torch.zeros((B, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                             device=device))


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, xc, B, C, dt) along the last axis."""
    din, GN = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return torch.split(proj, [din, din, GN, GN, cfg.ssm_heads], dim=-1)


# ---------------------------------------------------------------------------
# Chunked SSD
# ---------------------------------------------------------------------------


def _ssd_chunked(cfg: ModelConfig, x: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 h0: torch.Tensor):
    """Chunked SSD scan.

    x:  (B, S, H, P)   per-head inputs (P = head_dim)
    Bm: (B, S, G, N)   input projections (G groups over the heads)
    Cm: (B, S, G, N)   output projections
    dt: (B, S, H)      positive step sizes
    h0: (B, H, P, N)   initial state
    Returns (y (B, S, H, P), the final state).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    rep = H // G

    a = -torch.exp(A_log)                                   # (H,) negative
    xq = x.reshape(Bsz, nc, Q, H, P)
    # head h reads group h // rep (jnp.repeat, not Tensor.repeat)
    Bq = torch.repeat_interleave(Bm.reshape(Bsz, nc, Q, G, N), rep, dim=3)
    Cq = torch.repeat_interleave(Cm.reshape(Bsz, nc, Q, G, N), rep, dim=3)
    dtq = dt.reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtq * a, dim=2)                      # (B,nc,Q,H)

    # intra-chunk: M[t,s] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t
    CB = torch.einsum("bnqhx,bnshx->bnhqs", Cq, Bq)         # (B,nc,H,Q,Q)
    cum_h = cum.transpose(2, 3)                             # (B,nc,H,Q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]        # cum_t - cum_s
    # mask the exponent, not the product: above the diagonal diff >= 0
    # and exp() overflows, and inf * 0 is NaN in the backward pass
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri, diff, torch.full_like(diff, -torch.inf)).exp()
    M = CB * decay * dtq.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bnhqs,bnshp->bnqhp", M, xq)

    # each chunk's injected state: sum_s exp(cum_Q - cum_s) dt_s B_s x_s
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtq            # (B,nc,Q,H)
    chunk_state = torch.einsum("bnqhx,bnqhp->bnhpx", Bq * w[..., None], xq)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)

    # inter-chunk recurrence; h_prev[n] is the state BEFORE chunk n
    h, h_prev = h0, []
    for n in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, n, :, None, None] * h + chunk_state[:, n]
    h_prevs = torch.stack(h_prev, dim=1)                    # (B,nc,H,P,N)

    # inter-chunk contribution: y_t += C_t . (exp(cum_t) h_prev)
    y_inter = torch.einsum("bnqhx,bnhpx->bnqhp", Cq, h_prevs) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def _chunk_len(cfg: ModelConfig, S: int) -> int:
    """The reference's rule: min(chunk, S) when it divides S, else chunk
    (the time axis is then padded to a multiple of it)."""
    Q = min(cfg.ssm_chunk, S)
    return Q if S % Q == 0 else cfg.ssm_chunk


def ssm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[SSMState] = None
                ) -> Tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba-2 block.  x: (B, S, d) -> (y, new state).

    ``state`` carries the recurrent state and the causal conv's left
    context, so chunked prefill and the prefill -> decode hand-off are
    exact."""
    Bsz, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    din = cfg.d_inner

    z, xc, Bm, Cm, dt = _split_proj(cfg, dense(p["in_proj"], x))
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    if state is None:
        state = init_ssm_state(cfg, Bsz, x.dtype, x.device)
    conv_out = F.silu(causal_conv1d(p["conv"], conv_in,
                                    left_context=state.conv_buf))
    new_buf = torch.cat([state.conv_buf, conv_in],
                        dim=1)[:, -(cfg.ssm_conv - 1):, :]
    xc, Bm, Cm = torch.split(conv_out, [din, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])
    xh = xc.reshape(Bsz, S, H, P).float()
    Bm = Bm.reshape(Bsz, S, G, N).float()
    Cm = Cm.reshape(Bsz, S, G, N).float()

    # pad the time axis to a chunk multiple: padded steps carry dt = 0,
    # a decay of exp(0) = 1 and no contribution to the state (exact)
    Q = _chunk_len(cfg, S)
    pad = -S % Q
    if pad:
        xh_p, Bm_p, Cm_p = (F.pad(t, (0, 0, 0, 0, 0, pad))
                            for t in (xh, Bm, Cm))
        dt_p = F.pad(dt, (0, 0, 0, pad))
    else:
        xh_p, Bm_p, Cm_p, dt_p = xh, Bm, Cm, dt
    y, h_final = _ssd_chunked(cfg, xh_p, Bm_p, Cm_p, dt_p, p["A_log"],
                              state.h)
    y = y[:, :S] + p["D"][:, None] * xh
    y = y.reshape(Bsz, S, din).to(x.dtype)

    y = rmsnorm(p["out_norm"], y * F.silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y), SSMState(h=h_final, conv_buf=new_buf)


def ssm_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
               state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """The O(1) recurrent decode step.  x_t: (B, 1, d)."""
    Bsz = x_t.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    din = cfg.d_inner

    z, xc, Bm, Cm, dt = _split_proj(cfg, dense(p["in_proj"], x_t[:, 0, :]))
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    buf, conv_out = conv1d_step(p["conv"], state.conv_buf, conv_in)
    xc, Bm, Cm = torch.split(F.silu(conv_out), [din, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B, H)
    decay = torch.exp(dt * -torch.exp(p["A_log"]))          # (B, H)
    xh = xc.reshape(Bsz, H, P).float()
    Bh = torch.repeat_interleave(Bm.reshape(Bsz, G, N), H // G, dim=1).float()
    Ch = torch.repeat_interleave(Cm.reshape(Bsz, G, N), H // G, dim=1).float()

    h = decay[:, :, None, None] * state.h \
        + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + p["D"][:, None] * xh
    y = y.reshape(Bsz, 1, din).to(x_t.dtype)

    y = rmsnorm(p["out_norm"], y * F.silu(z[:, None, :]), cfg.norm_eps)
    return dense(p["out_proj"], y), SSMState(h=h, conv_buf=buf)
