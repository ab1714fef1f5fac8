"""Mamba2-130M [arXiv:2405.21060] -- SSD (state-space duality)
(repro/configs/mamba2_130m.py).

24L d_model=768, attention-free, ssm_state=128, vocab=50280.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mamba2_130m",
    arch_type="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    attn_kind="none",
    pos_kind="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    dtype="bfloat16",
))
