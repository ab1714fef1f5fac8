"""Attention (port of ``repro/models/attention.py``): grouped-query
attention with M-RoPE, and multi-head latent attention (MLA).

Projections use merged head dims (n_heads * head_dim), as the
reference's.  The full-sequence path runs the hand-written flash kernel
when ``cfg.use_flash`` and no window is set (``_flash_sdpa``), else the
flat-H plain attention ``_sdpa``; one-token decode runs the grouped
plain attention ``_sdpa_grouped`` against the KV cache, as the
reference does.  All three compute scores and weights in float32 and
return the input dtype.

KV cache: k / v (B, L, K, hd) and the position held in each slot
(``slot_pos``, -1 when empty).  Unlike the reference's functional
update, ``gqa_decode`` and ``transformer._fill_kv_cache`` write into
the cache's tensors in place and return the same cache (a full-width
cache is 151 MB at B = 4, L = 2048; a copy per token would move it
every step).

Sliding window (``window > 0``): the full-sequence path masks keys
more than ``window - 1`` positions back and never takes the flash
kernel, whatever ``cfg.use_flash`` says (the reference's rule,
``attention.py:273``).  The cache is then a ring of L = min(length,
window) slots: token p lives in slot p % L, ``slot_pos`` says which
token a slot holds, and decode masks by it; positions run past L.
Ring writes are plain slice copies into distinct slots, deterministic
on the card.

M-RoPE (``cfg.mrope_sections``, Qwen2-VL): q and k are rotated by three
position streams (t, h, w), ``layers.apply_mrope``.  ``positions`` of
shape (3, B, S) are used as given; (B, S) positions, or none, are the
same stream three times, and decode broadcasts its position likewise.

MLA (``cfg.attn_kind == "mla"``, MiniCPM3): queries and keys go through
low-rank latents (``w_dq`` / ``w_uq``, ``w_dkv`` / ``w_uk`` / ``w_uv``)
with a single rope key head shared by every head.  The full-sequence
path is plain float32 einsums, as the reference's (it never takes the
flash kernel).  The cache (``MLACache``) holds only the normed latent
``c`` (B, L, kv_lora) and the rotated rope key (B, L, rope_dim) a token;
``mla_decode`` scores against it in latent space (``absorbed=True``,
the default: W_uk folded into the query, values combined before W_uv)
or rebuilds every key and value (``absorbed=False``, the reference's
oracle).  It too writes the cache in place, a ring of L slots under a
window.

Cross attention (the Whisper decoder, ``cross_init`` /
``cross_precompute`` / ``cross_forward``): queries from the decoder,
keys and values projected once from the encoder's output, no mask, no
positions; one query token takes the grouped ``_sdpa_grouped`` (decode),
more take the flat-H ``_sdpa``, as the reference's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.flash import flash_attention
from .config import ModelConfig
from .layers import apply_mrope, apply_rope, dense, dense_init, rmsnorm

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor            # (B, L, K, hd)
    v: torch.Tensor            # (B, L, K, hd)
    slot_pos: torch.Tensor     # (L,) int32 position stored in each slot (-1 empty)

    @property
    def length(self) -> int:
        return self.k.shape[1]


class MLACache(NamedTuple):
    c: torch.Tensor            # (B, L, kv_lora)
    k_rope: torch.Tensor       # (B, L, rope_dim)
    slot_pos: torch.Tensor     # (L,)

    @property
    def length(self) -> int:
        return self.c.shape[1]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype,
                         bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=gen.device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=dtype,
                                           device=gen.device)}
    return p


def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = cfg.mla_nope_dim + cfg.mla_rope_dim
    ones = dict(dtype=dtype, device=gen.device)
    return {
        "w_dq": dense_init(gen, d, cfg.mla_q_lora, dtype),
        "q_norm": {"scale": torch.ones((cfg.mla_q_lora,), **ones)},
        "w_uq": dense_init(gen, cfg.mla_q_lora, H * qk_dim, dtype),
        "w_dkv": dense_init(gen, d, cfg.mla_kv_lora, dtype),
        "kv_norm": {"scale": torch.ones((cfg.mla_kv_lora,), **ones)},
        "w_kr": dense_init(gen, d, cfg.mla_rope_dim, dtype),
        "w_uk": dense_init(gen, cfg.mla_kv_lora, H * cfg.mla_nope_dim,
                           dtype),
        "w_uv": dense_init(gen, cfg.mla_kv_lora, H * cfg.mla_v_dim, dtype),
        "wo": dense_init(gen, H * cfg.mla_v_dim, d, dtype),
    }


def cross_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dtype),
    }


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    if cfg.attn_kind == "mla":
        return mla_init(gen, cfg, dtype)
    return gqa_init(gen, cfg, dtype)


# ---------------------------------------------------------------------------
# Scaled dot-product attention with GQA grouping
# ---------------------------------------------------------------------------


def _inv_sqrt(hd: int) -> float:
    """1 / sqrt(hd) rounded as the reference's float32 expression."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _flash_sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The flash kernel over (B, S, H, hd) heads: repeats GQA kv heads,
    folds (B, H) into the kernel's leading axis (a contiguous copy: at
    B = 1 the fold is a strided view, which the kernel refuses).  The
    kernel masks the ragged edge itself, so S needs no padding: its rows
    are the rows of the reference's padded call.

    A non-causal call whose S is above 128 and not a multiple of 128
    raises ``ValueError``: the reference pads S to its 128-row blocks,
    where the padded keys would leak into a non-causal softmax, and
    asserts (``src/repro/models/attention.py:141``).  The port's kernel
    could take it; the port refuses what the reference refuses."""
    B, S, H, hd = q.shape
    if not causal and S > 128 and S % 128:
        raise ValueError(f"non-causal flash attention needs S <= 128 or a "
                         f"multiple of 128, not {S}")
    K = k.shape[2]
    if K != H:
        k = torch.repeat_interleave(k, H // K, dim=2)
        v = torch.repeat_interleave(v, H // K, dim=2)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, t.shape[1], hd).contiguous()

    o = flash_attention(fold(q), fold(k), fold(v), causal=causal)
    return o.reshape(B, H, S, hd).transpose(1, 2)


def _mask_logits(logits: torch.Tensor, mask: Optional[torch.Tensor],
                 lead: int) -> torch.Tensor:
    if mask is None:
        return logits
    m = mask.reshape((1,) * lead + tuple(mask.shape[-2:]))
    return torch.where(m, logits, torch.full_like(logits, NEG_INF))


def _sdpa_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """GQA-grouped attention, no kv repeat: the decode path.
    q (B, S, H, hd), k / v (B, L, K, hd)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    logits = torch.einsum("bskgh,blkh->bkgsl", qg.float(), k.float()) * scale
    w = torch.softmax(_mask_logits(logits, mask, 3), dim=-1)
    out = torch.einsum("bkgsl,blkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """Flat-H attention: kv heads repeated to H.  q (B, S, H, hd),
    k / v (B, L, K, hd)."""
    H, K = q.shape[2], k.shape[2]
    if K != H:
        k = torch.repeat_interleave(k, H // K, dim=2)
        v = torch.repeat_interleave(v, H // K, dim=2)
    logits = torch.einsum("bshd,blhd->bhsl", q.float(), k.float()) * scale
    w = torch.softmax(_mask_logits(logits, mask, 2), dim=-1)
    out = torch.einsum("bhsl,blhd->bshd", w, v.float())
    return out.to(q.dtype)


def causal_mask(S: int, L: int, q_offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(S, L) boolean: query i (absolute position q_offset + i) may see
    key j."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(L, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


# ---------------------------------------------------------------------------
# GQA forward (full sequence) and decode step
# ---------------------------------------------------------------------------


def _positions_default(B: int, S: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    return (torch.arange(S, device=device) + offset).expand(B, S)


def _rotate(cfg: ModelConfig, q, k, positions):
    """RoPE, or M-RoPE when ``cfg.mrope_sections``: (B, S) positions are
    broadcast to 3 equal streams, (3, B, S) ones used as given."""
    if cfg.pos_kind != "rope":
        return q, k
    if cfg.mrope_sections:
        pos3 = positions if positions.dim() == 3 else positions.expand(
            (3,) + tuple(positions.shape))
        return (apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def gqa_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                causal: bool = True, window: int = 0,
                return_kv: bool = False):
    B, S, _ = x.shape
    hd = cfg.hd
    q, k, v = _qkv(cfg, p, x)
    pos = positions if positions is not None else _positions_default(
        B, S, device=x.device)
    q, k = _rotate(cfg, q, k, pos)
    if cfg.use_flash and window == 0:
        y = _flash_sdpa(cfg, q, k, v, causal)
    else:
        mask = causal_mask(S, S, 0, window, x.device) if causal else None
        y = _sdpa(q, k, v, mask, _inv_sqrt(hd))
    out = dense(p["wo"], y.reshape(B, S, cfg.n_heads * hd))
    if return_kv:
        return out, (k, v)
    return out


def init_kv_cache(cfg: ModelConfig, B: int, length: int, dtype,
                  device=None) -> KVCache:
    shape = (B, length, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((length,), -1, dtype=torch.int32, device=device))


def gqa_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor, pos: int,
               cache: KVCache, *, window: int = 0):
    """One token at absolute position ``pos`` (a host int) against the
    cache, which is written in place.  With ``window > 0`` the cache is
    a ring: the token goes to slot pos % L and any pos >= 0 is taken.
    Returns (out, cache)."""
    B = x_t.shape[0]
    hd = cfg.hd
    pos = int(pos)
    L = cache.length
    if pos < 0 or (window == 0 and pos >= L):
        raise ValueError(f"position {pos} outside the cache of {L} slots")
    slot = pos % L
    q, k, v = _qkv(cfg, p, x_t)
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x_t.device)
    q, k = _rotate(cfg, q, k, posb)

    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    cache.slot_pos[slot] = pos
    spos = cache.slot_pos
    valid = (spos >= 0) & (spos <= pos)
    if window > 0:
        valid &= spos > pos - window
    mask = valid.reshape(1, 1, 1, -1)
    y = _sdpa_grouped(q, cache.k, cache.v, mask, _inv_sqrt(hd))
    out = dense(p["wo"], y.reshape(B, 1, cfg.n_heads * hd))
    return out, cache


# ---------------------------------------------------------------------------
# MLA forward / decode
# ---------------------------------------------------------------------------


def _mla_qkv_full(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor):
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    q_lat = rmsnorm(p["q_norm"], dense(p["w_dq"], x), cfg.norm_eps)
    q = dense(p["w_uq"], q_lat).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c = rmsnorm(p["kv_norm"], dense(p["w_dkv"], x), cfg.norm_eps)
    k_rope = dense(p["w_kr"], x).reshape(B, S, 1, rope_d)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    k_nope = dense(p["w_uk"], c).reshape(B, S, H, nope)
    v = dense(p["w_uv"], c).reshape(B, S, H, vd)
    return q_nope, q_rope, k_nope, k_rope, v, c


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                causal: bool = True, window: int = 0,
                return_latent: bool = False):
    """Full-sequence MLA.  With ``return_latent`` also returns what the
    cache keeps of each token: (c (B, S, kv_lora), k_rope (B, S,
    rope_dim)), the reference's ``_mla_prefill`` recomputation."""
    B, S, _ = x.shape
    pos = positions if positions is not None else _positions_default(
        B, S, device=x.device)
    q_nope, q_rope, k_nope, k_rope, v, c = _mla_qkv_full(cfg, p, x, pos)
    k_rope = k_rope[:, :, 0]                     # the one shared head
    logits = (torch.einsum("bshd,blhd->bhsl", q_nope.float(),
                           k_nope.float())
              + torch.einsum("bshd,bld->bhsl", q_rope.float(),
                             k_rope.float())) \
        * _inv_sqrt(cfg.mla_nope_dim + cfg.mla_rope_dim)
    if causal:
        logits = _mask_logits(logits, causal_mask(S, S, 0, window,
                                                  x.device), 2)
    w = torch.softmax(logits, dim=-1)
    y = torch.einsum("bhsl,blhd->bshd", w, v.float()).to(x.dtype)
    out = dense(p["wo"], y.reshape(B, S, cfg.n_heads * cfg.mla_v_dim))
    if return_latent:
        return out, (c, k_rope)
    return out


def init_mla_cache(cfg: ModelConfig, B: int, length: int, dtype,
                   device=None) -> MLACache:
    return MLACache(
        c=torch.zeros((B, length, cfg.mla_kv_lora), dtype=dtype,
                      device=device),
        k_rope=torch.zeros((B, length, cfg.mla_rope_dim), dtype=dtype,
                           device=device),
        slot_pos=torch.full((length,), -1, dtype=torch.int32, device=device))


def mla_decode(cfg: ModelConfig, p: Params, x_t: torch.Tensor, pos: int,
               cache: MLACache, *, window: int = 0, absorbed: bool = True):
    """One token at absolute position ``pos`` (a host int) against the
    latent cache, written in place (slot pos % L under a window, as
    ``gqa_decode``).  ``absorbed`` scores in latent space, O(L kv_lora)
    a token: q_nope folded through W_uk, the weights applied to the
    latents before W_uv.  ``absorbed=False`` rebuilds every cached
    token's keys and values per head (the oracle).  Returns (out,
    cache)."""
    B = x_t.shape[0]
    H = cfg.n_heads
    nope, rope_d, vd, lora = (cfg.mla_nope_dim, cfg.mla_rope_dim,
                              cfg.mla_v_dim, cfg.mla_kv_lora)
    pos = int(pos)
    L = cache.length
    if pos < 0 or (window == 0 and pos >= L):
        raise ValueError(f"position {pos} outside the cache of {L} slots")
    slot = pos % L
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x_t.device)

    q_lat = rmsnorm(p["q_norm"], dense(p["w_dq"], x_t), cfg.norm_eps)
    q = dense(p["w_uq"], q_lat).reshape(B, 1, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    c_t = rmsnorm(p["kv_norm"], dense(p["w_dkv"], x_t), cfg.norm_eps)
    k_rope_t = apply_rope(dense(p["w_kr"], x_t).reshape(B, 1, 1, rope_d),
                          posb, cfg.rope_theta)

    cache.c[:, slot] = c_t[:, 0].to(cache.c.dtype)
    cache.k_rope[:, slot] = k_rope_t[:, 0, 0].to(cache.k_rope.dtype)
    cache.slot_pos[slot] = pos
    spos = cache.slot_pos
    valid = (spos >= 0) & (spos <= pos)
    if window > 0:
        valid &= spos > pos - window

    cc = cache.c.float()
    w_uk = p["w_uk"]["w"].reshape(lora, H, nope).float()
    if absorbed:
        q_lat_scores = torch.einsum("bshd,lhd->bhl", q_nope.float(), w_uk)
        s_nope = torch.einsum("bhl,bLl->bhL", q_lat_scores, cc)
    else:
        k_nope_all = torch.einsum("bLl,lhd->bLhd", cc, w_uk)
        s_nope = torch.einsum("bshd,bLhd->bhL", q_nope.float(), k_nope_all)
    s_rope = torch.einsum("bshd,bLd->bhL", q_rope.float(),
                          cache.k_rope.float())
    logits = (s_nope + s_rope) * _inv_sqrt(nope + rope_d)
    w = torch.softmax(_mask_logits(logits, valid[None, :], 1), dim=-1)

    w_uv = p["w_uv"]["w"].reshape(lora, H, vd).float()
    if absorbed:
        ctx_lat = torch.einsum("bhL,bLl->bhl", w, cc)
        y = torch.einsum("bhl,lhd->bhd", ctx_lat, w_uv)
    else:
        v_all = torch.einsum("bLl,lhd->bLhd", cc, w_uv)
        y = torch.einsum("bhL,bLhd->bhd", w, v_all)
    y = y.reshape(B, 1, H * vd).to(x_t.dtype)
    return dense(p["wo"], y), cache


# ---------------------------------------------------------------------------
# Cross-attention (the Whisper decoder)
# ---------------------------------------------------------------------------


def cross_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) attends to every encoder frame: enc_k / enc_v (B, F,
    K, hd) from ``cross_precompute``.  S == 1 (decode) takes the grouped
    form, no kv repeat; S > 1 the flat-H one."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    if S == 1:
        y = _sdpa_grouped(q, enc_k, enc_v, None, _inv_sqrt(hd))
    else:
        y = _sdpa(q, enc_k, enc_v, None, _inv_sqrt(hd))
    return dense(p["wo"], y.reshape(B, S, cfg.n_heads * hd))


def cross_precompute(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    """The encoder output's keys and values, (B, F, K, hd) each: once a
    prefill, kept in the decoder's caches."""
    B, L, _ = enc_out.shape
    hd = cfg.hd
    k = dense(p["wk"], enc_out).reshape(B, L, cfg.n_kv_heads, hd)
    v = dense(p["wv"], enc_out).reshape(B, L, cfg.n_kv_heads, hd)
    return k, v
