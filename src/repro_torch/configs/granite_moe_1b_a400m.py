"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]
(repro/configs/granite_moe_1b_a400m.py).

24L d_model=1024 16H (GQA kv=8) expert d_ff=512, MoE 32 experts top-8,
vocab=49155.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="granite_moe_1b_a400m",
    arch_type="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    expert_ff=512,
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
))
