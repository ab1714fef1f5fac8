"""Whisper-large-v3 [arXiv:2212.04356] -- encoder-decoder audio backbone
(repro/configs/whisper_large_v3.py).

32L (enc) + 32L (dec), d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
Mel+conv frontend is a STUB: input_specs provides 1500 frame embeddings.
LayerNorm + GELU (not RMS/GLU); learned decoder positions.
"""
from .base import register
from ..models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper_large_v3",
    arch_type="audio",
    n_layers=32,                  # decoder layers
    encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    norm_kind="layernorm",
    act="gelu",
    pos_kind="learned",
    attn_kind="gqa",
    n_audio_frames=1500,
    frontend="audio_stub",
    tie_embeddings=True,          # whisper ties emb/unemb
    dtype="bfloat16",
))
