"""Model API over the decoder-only families (port of
``repro/models/model.py``).

    api = build(cfg)
    params = api.init(seed_or_generator)        # device=None: the CUDA card
    loss   = api.loss(params, batch)            # train
    logits, aux = api.forward(params, batch)
    caches = api.init_caches(B, length)
    logits, caches = api.prefill(params, batch, caches)
    logits, caches = api.decode(params, caches, token, pos)

``batch`` is a dict with ``tokens`` (B, S) (and ``embeds`` for a
prefix, ``labels`` (B, S) for ``loss``).  ``init`` and ``init_caches``
resolve ``device=None`` to the CUDA card and raise where there is none;
a generator passed to ``init`` must live on that device.  The dense
(``attn``, sliding-window too, with M-RoPE or MLA), VLM (``embeds``
before the tokens), SSM (``ssm``) and hybrid (``rglru`` with local
attention) decoders run; ``init_caches`` gives one ``KVCache`` (a ring
when ``cfg.window > 0``), ``MLACache``, ``SSMState`` or ``LRUState`` per
layer, in pattern order.  The encoder-decoder family raises
``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from .. import device as device_mod
from . import transformer
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    forward: Callable[..., Any]
    init_caches: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]


def build(cfg: ModelConfig) -> ModelAPI:
    transformer.check_supported(cfg)

    def init(gen: Union[int, torch.Generator], device=None):
        dev = device_mod.resolve(device)
        if isinstance(gen, int):
            gen = torch.Generator(device=dev).manual_seed(gen)
        elif gen.device.type != dev.type:
            raise ValueError(f"the generator is on {gen.device}, the model "
                             f"on {dev}")
        return transformer.init_lm(gen, cfg)

    def loss(params, batch):
        return transformer.lm_loss(params, cfg, batch["tokens"],
                                   batch["labels"], batch.get("embeds"))

    def forward(params, batch):
        return transformer.forward_lm(params, cfg, batch.get("tokens"),
                                      batch.get("embeds"))

    def init_caches(B, length, dtype=None, device=None):
        return transformer.init_caches(cfg, B, length, dtype,
                                       device_mod.resolve(device))

    def prefill(params, batch, caches):
        return transformer.prefill(params, cfg, batch.get("tokens"), caches,
                                   batch.get("embeds"))

    def decode(params, caches, token, pos):
        return transformer.decode_step(params, cfg, caches, token, pos)

    return ModelAPI(cfg=cfg, init=init, loss=loss, forward=forward,
                    init_caches=init_caches, prefill=prefill, decode=decode)


def count_params(params) -> int:
    if torch.is_tensor(params):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)
