"""Qwen3-14B [hf:Qwen/Qwen3-8B family] -- qk_norm, GQA
(repro/configs/qwen3_14b.py).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen3_14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype="bfloat16",
))
