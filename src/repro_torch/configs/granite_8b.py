"""Granite-8B-Code [arXiv:2405.04324] -- llama architecture, code model
(repro/configs/granite_8b.py).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="granite_8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=49152,
    rope_theta=10_000_000.0,
    dtype="bfloat16",
))
