"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427]
(repro/configs/recurrentgemma_9b.py).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.
Temporal mixing pattern 1:2 -- (rglru, rglru, attn) repeated; local
(sliding-window 2048) attention; RG-LRU recurrence width = d_model.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="recurrentgemma_9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "attn"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    dtype="bfloat16",
))
