"""OLMoE-1B-7B [arXiv:2409.02060] -- 64 experts, top-8
(repro/configs/olmoe_1b_7b.py).

16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="olmoe_1b_7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    qk_norm=True,                 # OLMoE uses QK-norm
    n_experts=64,
    top_k=8,
    expert_ff=1024,
    rope_theta=10_000.0,
    dtype="bfloat16",
))
