"""Encoder-decoder model, the Whisper backbone (port of
``repro/models/encdec.py``).

The modality frontend (mel spectrogram and conv downsampling) is a stub,
as in the reference: the caller hands over frame embeddings (B, F, d).
Everything after it is real: sinusoidal encoder positions, non-causal
encoder self-attention, causal decoder self-attention with a KV cache,
cross-attention to keys and values projected once from the encoder's
output, learned decoder positions, LayerNorm and GELU MLPs.

Parameters: the reference's keys, with its stacked ``enc_blocks`` /
``dec_blocks`` as lists of one dictionary a layer (``convert.encdec_params``
unstacks the reference's tree): ``embed``, ``dec_pos`` (a learned table
of ``MAX_DEC_POS`` rows), ``enc_blocks``, ``enc_norm``, ``dec_blocks``,
``dec_norm`` and ``lm_head`` when the embeddings are untied.

Caches: a list with one dictionary a decoder layer, ``self`` (a
``KVCache``, a ring of min(length, window) slots when ``cfg.window > 0``)
and ``cross_k`` / ``cross_v`` (B, n_audio_frames, K, hd), which the
prefill fills and decode only reads; both written in place.

A decoder position past the table takes its last row, as the reference's
clipped ``take``; the rows are slices of the table, so their backward
adds no scattered rows.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from . import attention as attn
from . import transformer
from .config import ModelConfig
from .layers import _randn, dense, dense_init, embed, embed_init, mlp, \
    mlp_init, norm_apply, norm_init, sinusoidal_pos

Params = Dict[str, Any]

MAX_DEC_POS = 8192  # learned decoder position table size


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _enc_block_init(gen: torch.Generator, cfg: ModelConfig, dt) -> Params:
    return {
        "norm1": norm_init(cfg.norm_kind, cfg.d_model, dt, gen.device),
        "attn": attn.gqa_init(gen, cfg, dt),
        "norm2": norm_init(cfg.norm_kind, cfg.d_model, dt, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt, cfg.act),
    }


def _dec_block_init(gen: torch.Generator, cfg: ModelConfig, dt) -> Params:
    return {
        "norm1": norm_init(cfg.norm_kind, cfg.d_model, dt, gen.device),
        "self_attn": attn.gqa_init(gen, cfg, dt),
        "norm2": norm_init(cfg.norm_kind, cfg.d_model, dt, gen.device),
        "cross_attn": attn.cross_init(gen, cfg, dt),
        "norm3": norm_init(cfg.norm_kind, cfg.d_model, dt, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt, cfg.act),
    }


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Parameters drawn from ``gen`` on its device."""
    dt = transformer.torch_dtype(cfg)
    d = cfg.d_model
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, d, dt),
        "dec_pos": {"table": (_randn(gen, MAX_DEC_POS, d) * 0.01).to(dt)},
        "enc_blocks": [_enc_block_init(gen, cfg, dt)
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": norm_init(cfg.norm_kind, d, dt, gen.device),
        "dec_blocks": [_dec_block_init(gen, cfg, dt)
                       for _ in range(cfg.n_layers)],
        "dec_norm": norm_init(cfg.norm_kind, d, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.padded_vocab, dt)
    return params


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stub frontend embeddings -> encoder states."""
    B, F, d = frames.shape
    dt = transformer.torch_dtype(cfg)
    x = frames.to(dt) + sinusoidal_pos(F, d, dt, frames.device)[None]
    for bp in params["enc_blocks"]:
        h = norm_apply(cfg.norm_kind, bp["norm1"], x, cfg.norm_eps)
        x = x + attn.gqa_forward(cfg, bp["attn"], h, causal=False)
        h = norm_apply(cfg.norm_kind, bp["norm2"], x, cfg.norm_eps)
        x = x + mlp(bp["mlp"], h, cfg.act)
    return norm_apply(cfg.norm_kind, params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder (train / prefill / decode)
# ---------------------------------------------------------------------------


def _pos_rows(table: torch.Tensor, offset: int, S: int) -> torch.Tensor:
    """Rows offset .. offset + S - 1 of the position table, each index
    clipped to the last row: a slice, then the last row repeated."""
    M = table.shape[0]
    inside = max(0, min(S, M - offset))
    parts = [table[offset:offset + inside]] if inside else []
    if inside < S:
        parts.append(table[M - 1:M].expand(S - inside, -1))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _dec_embed(params: Params, tokens: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    x = embed(params["embed"], tokens)
    return x + _pos_rows(params["dec_pos"]["table"], offset,
                         tokens.shape[1])[None]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor):
    x = norm_apply(cfg.norm_kind, params["dec_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return dense(params["lm_head"], x)


def _cross_and_mlp(cfg: ModelConfig, bp: Params, x, ek, ev):
    h = norm_apply(cfg.norm_kind, bp["norm2"], x, cfg.norm_eps)
    x = x + attn.cross_forward(cfg, bp["cross_attn"], h, ek, ev)
    h = norm_apply(cfg.norm_kind, bp["norm3"], x, cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg.act)


def decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder forward -> logits (B, S, padded_vocab)."""
    x = _dec_embed(params, tokens)
    for bp in params["dec_blocks"]:
        h = norm_apply(cfg.norm_kind, bp["norm1"], x, cfg.norm_eps)
        x = x + attn.gqa_forward(cfg, bp["self_attn"], h, causal=True,
                                 window=cfg.window)
        ek, ev = attn.cross_precompute(cfg, bp["cross_attn"], enc_out)
        x = _cross_and_mlp(cfg, bp, x, ek, ev)
    return _logits(params, cfg, x)


def encdec_loss(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the true vocab, mean per token (no aux loss).
    The gold logit is a one-hot select and a sum, as
    ``transformer.lm_loss``'s: its backward is a select, not a scatter."""
    enc_out = encode(params, cfg, frames)
    logits = decode_train(params, cfg, tokens, enc_out).float()
    cols = torch.arange(cfg.padded_vocab, device=logits.device)
    pad_bias = torch.zeros(cfg.padded_vocab, dtype=torch.float32,
                           device=logits.device)
    pad_bias.masked_fill_(cols >= cfg.vocab, -1e30)
    logits = logits + pad_bias
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.where(cols == labels[..., None], logits,
                       torch.zeros((), device=logits.device)).sum(dim=-1)
    return torch.mean(logz - gold)


def init_dec_caches(cfg: ModelConfig, B: int, length: int, dtype=None,
                    device=None) -> List[dict]:
    """Per decoder layer: a self-attention ``KVCache`` of min(length,
    window) slots (``length`` without a window) and the cross K / V
    store of ``cfg.n_audio_frames`` frames."""
    dt = dtype or transformer.torch_dtype(cfg)
    L = min(length, cfg.window) if cfg.window > 0 else length
    shape = (B, cfg.n_audio_frames, cfg.n_kv_heads, cfg.hd)
    return [{"self": attn.init_kv_cache(cfg, B, L, dt, device),
             "cross_k": torch.zeros(shape, dtype=dt, device=device),
             "cross_v": torch.zeros(shape, dtype=dt, device=device)}
            for _ in range(cfg.n_layers)]


def prefill_decoder(params: Params, cfg: ModelConfig, frames: torch.Tensor,
                    tokens: torch.Tensor, caches: List[dict]):
    """Encode, then the teacher-forced decoder over ``tokens`` filling
    each layer's self-attention cache and cross K / V in place (the
    frames must number ``cfg.n_audio_frames``, the caches' size).
    Returns (last-token logits (B, 1, V), caches)."""
    enc_out = encode(params, cfg, frames)
    x = _dec_embed(params, tokens)
    S = tokens.shape[1]
    new_caches = []
    for bp, c in zip(params["dec_blocks"], caches):
        h = norm_apply(cfg.norm_kind, bp["norm1"], x, cfg.norm_eps)
        a, kv = attn.gqa_forward(cfg, bp["self_attn"], h, causal=True,
                                 window=cfg.window, return_kv=True)
        x = x + a
        self_cache = transformer._fill_kv_cache(cfg, c["self"], kv, S)
        ek, ev = attn.cross_precompute(cfg, bp["cross_attn"], enc_out)
        x = _cross_and_mlp(cfg, bp, x, ek, ev)
        c["cross_k"].copy_(ek)
        c["cross_v"].copy_(ev)
        new_caches.append(dict(c, self=self_cache))
    return _logits(params, cfg, x[:, -1:, :]), new_caches


def decode_step_encdec(params: Params, cfg: ModelConfig, caches: List[dict],
                       token: torch.Tensor, pos):
    """One decoder token (B, 1) at absolute position ``pos`` (a host int
    or a 0-d tensor) against the self and cross caches.  Returns (logits
    (B, 1, V), caches)."""
    pos = int(pos)
    x = _dec_embed(params, token, pos)
    new_caches = []
    for bp, c in zip(params["dec_blocks"], caches):
        h = norm_apply(cfg.norm_kind, bp["norm1"], x, cfg.norm_eps)
        a, self_cache = attn.gqa_decode(cfg, bp["self_attn"], h, pos,
                                        c["self"], window=cfg.window)
        x = _cross_and_mlp(cfg, bp, x + a, c["cross_k"], c["cross_v"])
        new_caches.append({"self": self_cache, "cross_k": c["cross_k"],
                           "cross_v": c["cross_v"]})
    return _logits(params, cfg, x), new_caches
