"""Qwen2.5-3B [hf:Qwen/Qwen2.5-0.5B family] (repro/configs/qwen2_5_3b.py).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936; QKV bias.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2_5_3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
))
