"""Qwen2-VL-2B language backbone [arXiv:2409.12191]
(repro/configs/qwen2_vl_2b.py).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  M-RoPE with
(t, h, w) sections; dynamic-resolution ViT is a STUB — input_specs
provides patch embeddings (B, vision_tokens, d_model).
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2_vl_2b",
    arch_type="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # sums to head_dim/2 = 64
    frontend="vision_stub",
    vision_tokens=1024,
    tie_embeddings=True,           # qwen2-vl-2b ties embeddings
    dtype="bfloat16",
))
