"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] -- MLA (multi-head latent attn)
(repro/configs/minicpm3_4b.py).

62L d_model=2560 40H d_ff=6400 vocab=73448.
MLA: q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_dim=64 --
decode cache stores only the 256-d latent + 32-d rope key per token.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="minicpm3_4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_kind="mla",
    mla_q_lora=768,
    mla_kv_lora=256,
    mla_rope_dim=32,
    mla_nope_dim=64,
    mla_v_dim=64,
    rope_theta=10_000.0,
    tie_embeddings=True,
    dtype="bfloat16",
))
