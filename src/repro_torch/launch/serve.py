"""Serving launch surface (port of ``repro/launch/serve.py``): the
kernel serving engine on a learner mesh, and the LM prefill / decode
steps.

``make_kernel_serving_engine`` is the mesh-aware constructor for
``serving.KernelServingEngine``: it builds the learner mesh
(``launch.mesh.make_learner_mesh``) over the visible cards and the
engine routes every predict request to its home shard, each shard with
its own slot pool (``slots`` is per shard).  Every other keyword
forwards to the engine; none of them can change the protocol view.

``make_prefill_step`` / ``make_decode_step`` are one-line wrappers over
the LM api of ``models.build`` (the decoded token is the argmax over
the first ``cfg.vocab`` logits), for every family: an audio model's
batch holds ``frames`` beside its decoder ``tokens``, which
``serving.lm.LMServingEngine`` (tokens only, as the reference's) does
not build, so the encoder-decoder is served through these steps.
"""
from __future__ import annotations

import torch

from ..models import build
from ..models.config import ModelConfig


def make_kernel_serving_engine(learner, pcfg, m: int, *, devices: int = 0,
                               **engine_kw):
    """A ``serving.KernelServingEngine`` with its learner axis sharded
    over a learner mesh of ``devices`` shards (0: one per visible card;
    m must divide evenly).  ``mesh=`` is refused: this function owns
    the mesh.  With one shard the routing is the identity."""
    from ..serving import KernelServingEngine
    from .mesh import make_learner_mesh

    if "mesh" in engine_kw:
        raise ValueError(
            "pass devices=..., not mesh=; make_kernel_serving_engine "
            "owns the mesh construction")
    mesh = make_learner_mesh(devices)
    return KernelServingEngine(learner, pcfg, m, mesh=mesh, **engine_kw)


def make_prefill_step(cfg: ModelConfig):
    api = build(cfg)

    def prefill_step(params, batch, caches):
        return api.prefill(params, batch, caches)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    api = build(cfg)

    def serve_step(params, caches, token, pos):
        logits, new_caches = api.decode(params, caches, token, pos)
        next_token = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(
            torch.int32)
        return next_token, new_caches

    return serve_step
