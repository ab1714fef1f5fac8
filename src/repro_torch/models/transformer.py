"""Decoder-only LM assembly (port of ``repro/models/transformer.py``).

Parameters are plain dictionaries with the reference's keys: ``embed``,
``final_norm``, ``lm_head`` (untied only) and ``layers``, one block
dictionary per layer, layer i of kind ``cfg.pattern[i]``.  The
reference stacks each stage's units and scans over them
(``params["stages"][s]["b{j}"]`` with a leading axis of the stage's
repeats); here that scan is a Python loop over ``layers``, and
``convert.lm_params`` unstacks the reference's tree.  Caches are a list
with one cache per layer: a ``KVCache`` for an attention block, written
in place (a ring of min(length, window) slots when ``cfg.window > 0``),
or the fixed-size state of a recurrent block (``ssm.SSMState``,
``rglru.LRUState``), replaced by the new state at each call.

Four entry points, as the reference's:
  forward_lm   -- full-sequence logits (+ the MoE aux loss, summed over
                  the layers)
  prefill      -- full-sequence forward that also fills the caches
  decode_step  -- one token against the caches
  lm_loss      -- the next-token cross-entropy plus the aux loss

Four block kinds run: ``attn`` (the dense decoder, local attention
when ``cfg.window > 0``; grouped-query attention with RoPE or M-RoPE, or
MLA with its latent cache, ``MLACache``), ``moe`` (the same attention,
then a mixture of experts, ``models/moe.py``: the grouped routed path
with its aux loss on the full-sequence paths, the capacity-free dense
form in decode), ``ssm`` (Mamba-2, ``models/ssm.py``; no positions, an
aux loss of 0) and ``rglru`` (the Griffin recurrent block with its MLP,
``models/rglru.py``), in any pattern of units and stages
(``recurrentgemma_9b``: (rglru, rglru, attn) x 12, then (rglru,
rglru)).  A VLM's ``embeds`` (B, vision_tokens, d) go before the
tokens' embeddings (``qwen2_vl_2b``).  The encoder-decoder family has
its own assembly, ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import Draws, as_draws, dense, dense_init, embed, embed_init, \
    mlp, mlp_init, norm_apply, norm_init

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


#: the block kinds of a decoder
BLOCK_KINDS = frozenset(("attn", "moe", "ssm", "rglru"))


def _check_kind(kind: str) -> None:
    """An unknown block kind raises, as the reference's blocks do."""
    if kind not in BLOCK_KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block init / forward / decode
# ---------------------------------------------------------------------------


def block_init(rng, cfg: ModelConfig, kind: str) -> Params:
    rng = as_draws(rng)
    _check_kind(kind)
    dt, d, dev = torch_dtype(cfg), cfg.d_model, rng.device
    k1, k2, _, _ = rng.split(4)
    if kind == "ssm":
        return {"norm1": norm_init(cfg.norm_kind, d, dt, dev),
                "ssm": ssm_mod.ssm_init(k1, cfg, dt)}
    if kind == "rglru":
        return {"norm1": norm_init(cfg.norm_kind, d, dt, dev),
                "rglru": rglru_mod.rglru_init(k1, cfg, dt),
                "norm2": norm_init(cfg.norm_kind, d, dt, dev),
                "mlp": mlp_init(k2, d, cfg.d_ff, dt, cfg.act)}
    out = {
        "norm1": norm_init(cfg.norm_kind, d, dt, dev),
        "attn": attn.attn_init(k1, cfg, dt),
        "norm2": norm_init(cfg.norm_kind, d, dt, dev),
    }
    if kind == "moe":
        out["moe"] = moe_mod.moe_init(k2, cfg, dt)
    else:
        out["mlp"] = mlp_init(k2, d, cfg.d_ff, dt, cfg.act)
    return out


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def block_forward(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor,
                  positions: Optional[torch.Tensor]):
    """Returns (x, aux_loss)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(cfg.norm_kind, p["norm1"], x, eps)
    if kind == "ssm":
        return x + ssm_mod.ssm_forward(cfg, p["ssm"], h)[0], _zero_aux(x)
    if kind == "rglru":
        x = x + rglru_mod.rglru_forward(cfg, p["rglru"], h)[0]
    elif cfg.attn_kind == "mla":
        x = x + attn.mla_forward(cfg, p["attn"], h, positions,
                                 window=cfg.window)
    else:
        x = x + attn.gqa_forward(cfg, p["attn"], h, positions,
                                 window=cfg.window)
    h = norm_apply(cfg.norm_kind, p["norm2"], x, eps)
    if kind == "moe":
        y, aux = moe_mod.moe_forward(cfg, p["moe"], h)
        return x + y, aux
    return x + mlp(p["mlp"], h, cfg.act), _zero_aux(x)


def block_cache_init(cfg: ModelConfig, kind: str, B: int, length: int,
                     dtype, device=None):
    _check_kind(kind)
    # a recurrent block's state has a fixed size, whatever the length
    if kind == "ssm":
        return ssm_mod.init_ssm_state(cfg, B, dtype, device)
    if kind == "rglru":
        return rglru_mod.init_lru_state(cfg, B, dtype, device)
    L = min(length, cfg.window) if cfg.window > 0 else length
    if cfg.attn_kind == "mla":
        return attn.init_mla_cache(cfg, B, L, dtype, device)
    return attn.init_kv_cache(cfg, B, L, dtype, device)


def _fill_kv_cache(cfg: ModelConfig, cache: attn.KVCache, kv,
                   S: int) -> attn.KVCache:
    """Write the prefill's keys and values into slots 0 .. S-1, in
    place; the other slots are marked empty.  A ring (``cfg.window >
    0``) shorter than the prompt keeps its last L tokens, token p in
    slot p % L: two slice copies of a rotation."""
    k, v = kv                                   # (B, S, K, hd)
    L = cache.length
    dev = cache.slot_pos.device
    if cfg.window > 0 and S > L:
        r = S % L                               # the slot of token S - L
        for dst, src in ((cache.k, k), (cache.v, v)):
            src = src[:, S - L:].to(dst.dtype)
            dst[:, r:] = src[:, :L - r]
            dst[:, :r] = src[:, L - r:]
        slots = torch.arange(L, dtype=torch.int32, device=dev)
        cache.slot_pos.copy_((slots - r) % L + (S - L))
        return cache
    if S > L:
        raise ValueError(f"prefill of {S} tokens into a cache of {L} slots")
    cache.k[:, :S] = k.to(cache.k.dtype)
    cache.v[:, :S] = v.to(cache.v.dtype)
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    cache.slot_pos.copy_(torch.where(pos < S, pos, torch.full_like(pos, -1)))
    return cache


def _mla_prefill(cfg: ModelConfig, p: Params, h, positions,
                 cache: attn.MLACache):
    """MLA over the prompt, its latents and rope keys written into
    slots 0 .. S-1 in place, the other slots marked empty.  A prompt
    longer than the cache raises, windowed or not: the reference's
    ``lax.dynamic_update_slice`` refuses it too (it has no ring fill for
    MLA)."""
    S = h.shape[1]
    L = cache.length
    if S > L:
        raise ValueError(f"MLA prefill of {S} tokens into a cache of {L} "
                         f"slots")
    a, (c, k_rope) = attn.mla_forward(cfg, p, h, positions,
                                      window=cfg.window, return_latent=True)
    cache.c[:, :S] = c.to(cache.c.dtype)
    cache.k_rope[:, :S] = k_rope.to(cache.k_rope.dtype)
    pos = torch.arange(L, dtype=torch.int32, device=cache.slot_pos.device)
    cache.slot_pos.copy_(torch.where(pos < S, pos, torch.full_like(pos, -1)))
    return a, cache


def block_prefill(cfg: ModelConfig, kind: str, p: Params, cache, x,
                  positions: Optional[torch.Tensor]):
    """Full-sequence forward that also fills this block's cache.
    Returns (x, cache, aux)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    S = x.shape[1]
    h = norm_apply(cfg.norm_kind, p["norm1"], x, eps)
    if kind == "ssm":
        y, state = ssm_mod.ssm_forward(cfg, p["ssm"], h, cache)
        return x + y, state, _zero_aux(x)
    if kind == "rglru":
        a, cache = rglru_mod.rglru_forward(cfg, p["rglru"], h, cache)
    elif cfg.attn_kind == "mla":
        a, cache = _mla_prefill(cfg, p["attn"], h, positions, cache)
    else:
        a, kv = attn.gqa_forward(cfg, p["attn"], h, positions,
                                 window=cfg.window, return_kv=True)
        cache = _fill_kv_cache(cfg, cache, kv, S)
    x = x + a
    h = norm_apply(cfg.norm_kind, p["norm2"], x, eps)
    if kind == "moe":
        y, aux = moe_mod.moe_forward(cfg, p["moe"], h)
        return x + y, cache, aux
    return x + mlp(p["mlp"], h, cfg.act), cache, _zero_aux(x)


def block_decode(cfg: ModelConfig, kind: str, p: Params, cache, x_t, pos):
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(cfg.norm_kind, p["norm1"], x_t, eps)
    if kind == "ssm":
        y, state = ssm_mod.ssm_decode(cfg, p["ssm"], h, cache)
        return x_t + y, state
    if kind == "rglru":
        a, cache = rglru_mod.rglru_decode(cfg, p["rglru"], h, cache)
    elif cfg.attn_kind == "mla":
        a, cache = attn.mla_decode(cfg, p["attn"], h, pos, cache,
                                   window=cfg.window)
    else:
        a, cache = attn.gqa_decode(cfg, p["attn"], h, pos, cache,
                                   window=cfg.window)
    x_t = x_t + a
    h = norm_apply(cfg.norm_kind, p["norm2"], x_t, eps)
    if kind == "moe":
        return x_t + moe_mod.moe_forward_dense(cfg, p["moe"], h)[0], cache
    return x_t + mlp(p["mlp"], h, cfg.act), cache


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def layer_draws(rng, cfg: ModelConfig) -> List[Draws]:
    """Each layer's draws, in pattern order, from the reference's stage
    keys: stage si takes ``fold_in(ks, si)`` split into its repeats, and
    each repeat splits into its unit's blocks (the reference's
    ``jax.vmap(init_unit)`` draws each repeat from its own key)."""
    rng = as_draws(rng)
    out = []
    for si, (unit, repeats) in enumerate(cfg.stages):
        for k in rng.fold_in(si).split(repeats):
            out.extend(k.split(len(unit)))
    return out


def init_lm(rng, cfg: ModelConfig) -> Params:
    """Parameters drawn from ``rng`` on its device, the reference's key
    tree: split 3 ways (embedding, head, stages)."""
    rng = as_draws(rng)
    dt = torch_dtype(cfg)
    ke, kh, ks = rng.split(3)
    params: Params = {
        "embed": embed_init(ke, cfg.padded_vocab, cfg.d_model, dt),
        "final_norm": norm_init(cfg.norm_kind, cfg.d_model, dt, rng.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(kh, cfg.d_model, cfg.padded_vocab, dt)
    params["layers"] = [block_init(k, cfg, kind) for k, kind
                        in zip(layer_draws(ks, cfg), cfg.pattern)]
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
    parts = []
    if embeds is not None:
        parts.append(embeds.to(torch_dtype(cfg)))
    if tokens is not None:
        parts.append(embed(params["embed"], tokens))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(cfg.norm_kind, params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return dense(params["lm_head"], x)


def forward_lm(params: Params, cfg: ModelConfig,
               tokens: Optional[torch.Tensor],
               embeds: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None):
    """Returns (logits over padded_vocab, aux_loss)."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    aux = _zero_aux(x)
    for kind, p in zip(cfg.pattern, params["layers"]):
        x, a = block_forward(cfg, kind, p, x, positions)
        aux = aux + a
    return _logits(params, cfg, x), aux


def lm_loss(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy over the true vocab, mean per token, plus the aux
    loss (the MoE layers' sum; 0 for the other kinds).  The padded vocab columns are masked
    by an additive bias fused into the float32 upcast; with ``embeds``
    only the trailing ``labels.shape[1]`` positions count.

    The gold logit is picked by a one-hot select and a sum (exact: one
    term is not zero), not by a gather, so its backward is an
    elementwise select and never a scatter: deterministic on the card.
    """
    logits, aux = forward_lm(params, cfg, tokens, embeds)
    if embeds is not None:
        logits = logits[:, -labels.shape[1]:, :]
    cols = torch.arange(cfg.padded_vocab, device=logits.device)
    pad_bias = torch.zeros(cfg.padded_vocab, dtype=torch.float32,
                           device=logits.device)
    pad_bias.masked_fill_(cols >= cfg.vocab, -1e30)
    logits = logits.float() + pad_bias
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.where(cols == labels[..., None], logits,
                       torch.zeros((), device=logits.device)).sum(dim=-1)
    return torch.mean(logz - gold) + aux


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, B: int, length: int, dtype=None,
                device=None) -> list:
    """One empty cache per layer, in pattern order (a recurrent layer's
    does not depend on ``length``; a windowed attention layer's holds
    min(length, window) slots)."""
    dt = dtype or torch_dtype(cfg)
    return [block_cache_init(cfg, kind, B, length, dt, device)
            for kind in cfg.pattern]


def prefill(params: Params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            caches, embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Full-sequence forward filling the caches.  Returns (last-token
    logits (B, 1, V), caches)."""
    x = _embed_inputs(params, cfg, tokens, embeds)
    new_caches = []
    for kind, p, c in zip(cfg.pattern, params["layers"], caches):
        x, c, _ = block_prefill(cfg, kind, p, c, x, positions)
        new_caches.append(c)
    return _logits(params, cfg, x[:, -1:, :]), new_caches


def decode_step(params: Params, cfg: ModelConfig, caches,
                token: torch.Tensor, pos):
    """token: (B, 1) ints; pos: the new token's absolute position (a
    host int or a 0-d tensor).  Returns (logits (B, 1, V), caches)."""
    pos = int(pos)
    x = embed(params["embed"], token)
    new_caches = []
    for kind, p, c in zip(cfg.pattern, params["layers"], caches):
        x, c = block_decode(cfg, kind, p, c, x, pos)
        new_caches.append(c)
    return _logits(params, cfg, x), new_caches
