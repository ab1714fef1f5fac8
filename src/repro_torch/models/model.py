"""Model API over the decoder-only and encoder-decoder families (port of
``repro/models/model.py``).

    api = build(cfg)
    params = api.init(seed_or_generator)        # device=None: the CUDA card
    loss   = api.loss(params, batch)            # train
    logits, aux = api.forward(params, batch)
    caches = api.init_caches(B, length)
    logits, caches = api.prefill(params, batch, caches)
    logits, caches = api.decode(params, caches, token, pos)

``batch`` is a dict; which keys exist depends on the family:
  text LM:   tokens (B, S), labels (B, S)
  vlm:       embeds (B, S_img, d) + tokens (B, S_txt) + labels (B, S_txt)
  audio:     frames (B, F, d) + tokens (B, S) + labels (B, S)
``init`` and ``init_caches`` resolve ``device=None`` to the CUDA card
and raise where there is none; a generator passed to ``init`` must live
on that device.  Every family of the reference runs: the dense
(``attn``, sliding-window too, with M-RoPE or MLA), MoE (``moe``), VLM
(``embeds`` before the tokens), SSM (``ssm``) and hybrid (``rglru``
with local attention) decoders, whose ``init_caches`` gives one
``KVCache`` (a ring when ``cfg.window > 0``), ``MLACache``, ``SSMState``
or ``LRUState`` a layer in pattern order; and the encoder-decoder
(``cfg.encoder_layers > 0``, ``models/encdec.py``), whose caches are a
self-attention ``KVCache`` and the cross K / V a decoder layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from .. import device as device_mod
from . import encdec, transformer
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


def _generator(gen: Union[int, torch.Generator], device) -> torch.Generator:
    dev = device_mod.resolve(device)
    if isinstance(gen, int):
        return torch.Generator(device=dev).manual_seed(gen)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the model "
                         f"on {dev}")
    return gen


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encdec:
        return _build_encdec(cfg)
    return _build_decoder_only(cfg)


def _build_decoder_only(cfg: ModelConfig) -> ModelAPI:
    def init(gen: Union[int, torch.Generator], device=None):
        return transformer.init_lm(_generator(gen, device), cfg)

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


def _build_encdec(cfg: ModelConfig) -> ModelAPI:
    def init(gen: Union[int, torch.Generator], device=None):
        return encdec.init_encdec(_generator(gen, device), cfg)

    def loss(params, batch):
        return encdec.encdec_loss(params, cfg, batch["frames"],
                                  batch["tokens"], batch["labels"])

    def forward(params, batch):
        enc = encdec.encode(params, cfg, batch["frames"])
        logits = encdec.decode_train(params, cfg, batch["tokens"], enc)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def init_caches(B, length, dtype=None, device=None):
        return encdec.init_dec_caches(cfg, B, length, dtype,
                                      device_mod.resolve(device))

    def prefill(params, batch, caches):
        return encdec.prefill_decoder(params, cfg, batch["frames"],
                                      batch["tokens"], caches)

    def decode(params, caches, token, pos):
        return encdec.decode_step_encdec(params, cfg, caches, token, pos)

    return ModelAPI(cfg=cfg, init=init, loss=loss, forward=forward,
                    init_caches=init_caches, prefill=prefill, decode=decode)


def count_params(params) -> int:
    if torch.is_tensor(params):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)
