"""The assigned input shapes and their shape-only stand-ins (port of
``repro/launch/specs.py``).

Shapes (from the assignment):
  train_4k     seq=4096    global_batch=256   -> protocol train_step
  prefill_32k  seq=32768   global_batch=32    -> prefill_step
  decode_32k   seq=32768   global_batch=128   -> serve_step (1 token)
  long_500k    seq=524288  global_batch=1     -> serve_step (1 token)

Where the reference returns ``jax.ShapeDtypeStruct``s, these functions
return tensors on the ``meta`` device: a shape and a dtype, no storage
on any device.  The parameter and cache shapes come from the port's own
initializers (``transformer.init_lm`` / ``init_caches``, or
``encdec.init_encdec`` / ``init_dec_caches`` for the encoder-decoder)
run on ``meta`` (a generator whose draws land there), so they are the
production trees.

The long-context policy (``variant_for``): ``long_500k`` needs
sub-quadratic attention, so a dense, VLM or audio architecture runs its
sliding-window variant (``window = long_context_window``, 4096), whose
KV cache is a ring of 4096 slots a layer whatever the context length;
SSM and hybrid architectures run as they are.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import encdec, transformer
from ..models.config import ModelConfig
from ..tree import tree_map

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    dict(kind="train",   seq=4_096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32_768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524_288, batch=1),
}

CACHE_MARGIN = 128   # decode caches hold seq_len context + margin slots

META = torch.device("meta")


def variant_for(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """``long_500k`` switches a dense / VLM / audio arch (one with
    attention and no window) to its sliding-window variant; every other
    (arch, shape) is ``cfg`` itself."""
    if shape_name == "long_500k" and cfg.attn_kind != "none" \
            and cfg.window == 0:
        return cfg.with_(window=cfg.long_context_window)
    return cfg


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, m: int, shape: Dict[str, Any]):
    """Stacked-learner batch: leading dim m (one slice per learner)."""
    B, S = shape["batch"], shape["seq"]
    if B % m:
        raise ValueError(f"a global batch of {B} does not split over {m} "
                         f"learners")
    b = B // m
    dt = transformer.torch_dtype(cfg)
    if cfg.arch_type == "vlm":
        sv = cfg.vision_tokens
        return {"embeds": _sds((m, b, sv, cfg.d_model), dt),
                "tokens": _sds((m, b, S - sv), torch.int32),
                "labels": _sds((m, b, S - sv), torch.int32)}
    if cfg.arch_type == "audio":
        return {"frames": _sds((m, b, cfg.n_audio_frames, cfg.d_model), dt),
                "tokens": _sds((m, b, S), torch.int32),
                "labels": _sds((m, b, S), torch.int32)}
    return {"tokens": _sds((m, b, S), torch.int32),
            "labels": _sds((m, b, S), torch.int32)}


def prefill_batch_specs(cfg: ModelConfig, shape: Dict[str, Any]):
    B, S = shape["batch"], shape["seq"]
    dt = transformer.torch_dtype(cfg)
    if cfg.arch_type == "vlm":
        sv = cfg.vision_tokens
        return {"embeds": _sds((B, sv, cfg.d_model), dt),
                "tokens": _sds((B, S - sv), torch.int32)}
    if cfg.arch_type == "audio":
        return {"frames": _sds((B, cfg.n_audio_frames, cfg.d_model), dt),
                "tokens": _sds((B, S), torch.int32)}
    return {"tokens": _sds((B, S), torch.int32)}


def cache_specs(cfg: ModelConfig, B: int, length: int) -> list:
    """``init_caches(B, length)``'s tree, one cache a layer, on meta."""
    if cfg.is_encdec:
        return encdec.init_dec_caches(cfg, B, length, device=META)
    return transformer.init_caches(cfg, B, length, device=META)


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws the initializers place on ``meta``
    (they draw on ``gen.device``): shapes and dtypes, no numbers."""

    @property
    def device(self) -> torch.device:
        return META


def param_specs(cfg: ModelConfig) -> dict:
    """``build(cfg).init``'s tree on meta."""
    if cfg.is_encdec:
        return encdec.init_encdec(_MetaGenerator(), cfg)
    return transformer.init_lm(_MetaGenerator(), cfg)


def stacked_param_specs(cfg: ModelConfig, m: int) -> dict:
    return tree_map(lambda x: _sds((m,) + tuple(x.shape), x.dtype),
                    param_specs(cfg))


def input_specs(cfg: ModelConfig, shape_name: str, m: int = 1):
    """The batch-side stand-ins for one (arch, shape) combination: a
    training or prefill batch, or a decode step's token, position and
    caches of seq + ``CACHE_MARGIN`` slots (a ring of ``window`` slots
    for a windowed attention layer)."""
    shape = SHAPES[shape_name]
    cfg = variant_for(cfg, shape_name)
    if shape["kind"] == "train":
        return train_batch_specs(cfg, m, shape)
    if shape["kind"] == "prefill":
        return prefill_batch_specs(cfg, shape)
    B = shape["batch"]
    return {"token": _sds((B, 1), torch.int32),
            "pos": _sds((), torch.int32),
            "caches": cache_specs(cfg, B, shape["seq"] + CACHE_MARGIN)}
