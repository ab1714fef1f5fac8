"""Architecture configuration for the model zoo (an own copy of
``repro/models/config.py``: the same dataclass, fields, defaults and
``smoke()``, so a configuration means the same model on both sides).

One ``ModelConfig`` covers all six architecture families of the
reference: dense / MoE / SSM / hybrid / VLM / audio, all of which the
port runs (the decoders in ``models/transformer.py``, the
encoder-decoder in ``models/encdec.py``).  Fields that only steer XLA (``remat*``,
``shard_activations``, ``act_batch_axes``, ``unroll_scan``) are kept
and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    arch_type: str = "dense"          # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1000

    head_dim: int = 0                 # 0 -> d_model // n_heads
    norm_kind: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu_glu"             # silu_glu | gelu (whisper)
    tie_embeddings: bool = False
    dtype: str = "float32"            # compute/param dtype
    vocab_pad: int = 256              # pad vocab to a multiple (sharding)

    # --- attention flavour -------------------------------------------------
    attn_kind: str = "gqa"            # gqa | mla | none
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2/2.5
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) halves
    window: int = 0                   # >0: sliding-window attention
    pos_kind: str = "rope"            # rope | sinusoidal | learned | none

    # --- MLA (minicpm3 / deepseek-style) -----------------------------------
    mla_q_lora: int = 0
    mla_kv_lora: int = 0
    mla_rope_dim: int = 0
    mla_nope_dim: int = 0
    mla_v_dim: int = 0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0                # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_group_size: int = 256         # grouped-dispatch token group (§Perf)

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # --- hybrid (recurrentgemma / griffin) ----------------------------------
    # pattern of block kinds repeated through depth, e.g. ("rglru","rglru","attn")
    layer_pattern: Tuple[str, ...] = ()
    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4

    # --- encoder-decoder (whisper) -------------------------------------------
    encoder_layers: int = 0
    n_audio_frames: int = 1500

    # --- modality frontend (stub) --------------------------------------------
    frontend: str = "none"            # none | audio_stub | vision_stub
    vision_tokens: int = 0            # VLM: patch-embedding positions per sample

    # --- long-context variant -------------------------------------------------
    long_context_window: int = 4096   # window used when a dense arch runs 500k

    # --- training ---------------------------------------------------------------
    remat: bool = False               # activation checkpointing around each unit
    remat_policy: str = "full"        # full | dots  (dots: save matmul
                                      # outputs, recompute elementwise only)
    use_flash: bool = False           # hand-written flash-attention path
                                      # (kernels/flash.py) for prefill
    shard_activations: bool = False   # head-parallel attention constraints
                                      # (production mesh; no-op on 1 device)
    act_batch_axes: Tuple[str, ...] = ()  # mesh axes pinning the activation
                                      # batch dim (serve paths; empty under
                                      # the vmapped learner train path)
    unroll_scan: bool = False         # fully unroll layer scans (dry-run only:
                                      # XLA cost analysis counts while-loop
                                      # bodies once, so the roofline needs the
                                      # unrolled HLO for exact flops/collectives)

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.arch_type not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(self.arch_type)
        if self.attn_kind not in ("gqa", "mla", "none"):
            raise ValueError(self.attn_kind)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, self.vocab_pad)

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Block-kind sequence of length n_layers."""
        if self.layer_pattern:
            unit = self.layer_pattern
            reps = (self.n_layers + len(unit) - 1) // len(unit)
            return tuple((unit * reps)[: self.n_layers])
        kind = {"moe": "moe", "ssm": "ssm"}.get(self.arch_type, "attn")
        return (kind,) * self.n_layers

    @property
    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose the pattern into (unit, repeats) stages so each
        stage is a lax.scan over identically-structured units.  Uniform
        archs give one stage; recurrentgemma-9b (38 layers, unit of 3)
        gives [(unit, 12), (('rglru','rglru'), 1)]."""
        pat = self.pattern
        if not self.layer_pattern:
            return (((pat[0],), self.n_layers),)
        unit = self.layer_pattern
        full = len(pat) // len(unit)
        out = []
        if full:
            out.append((unit, full))
        rem = pat[full * len(unit):]
        if rem:
            out.append((tuple(rem), 1))
        return tuple(out)

    @property
    def d_inner(self) -> int:         # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family: <=2 layers (plus pattern
        coverage), d_model<=256, <=4 experts — for CPU smoke tests."""
        n_layers = len(self.layer_pattern) or 2
        kw = dict(
            n_layers=max(n_layers, 2),
            d_model=256,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 4,
            head_dim=64,
            d_ff=512,
            vocab=512,
            dtype="float32",
            window=min(self.window, 32) if self.window else 0,
        )
        if self.mrope_sections:
            kw.update(mrope_sections=(8, 12, 12))   # sums to 64/2
        if self.n_experts:
            # capacity_factor high enough that the routed path drops no
            # tokens at smoke scale -> routed == dense numerics.
            kw.update(n_experts=4, top_k=2, expert_ff=128, capacity_factor=8.0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
        if self.mla_kv_lora:
            kw.update(mla_q_lora=64, mla_kv_lora=32, mla_rope_dim=16,
                      mla_nope_dim=32, mla_v_dim=32)
        if self.lru_width:
            kw.update(lru_width=256)
        if self.encoder_layers:
            kw.update(encoder_layers=2, n_audio_frames=16)
        if self.vision_tokens:
            kw.update(vision_tokens=8)
        return self.with_(**kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6ND model-FLOPs and memory
    sanity; exact counts come from the initialized pytree)."""
    d, hd = cfg.d_model, cfg.hd
    emb = cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    per_layer = 0
    for kind in cfg.pattern:
        if kind == "attn":
            if cfg.attn_kind == "mla":
                q = d * cfg.mla_q_lora + cfg.mla_q_lora * cfg.n_heads * (
                    cfg.mla_nope_dim + cfg.mla_rope_dim)
                kv = d * (cfg.mla_kv_lora + cfg.mla_rope_dim) + cfg.mla_kv_lora * (
                    cfg.n_heads * (cfg.mla_nope_dim + cfg.mla_v_dim))
                o = cfg.n_heads * cfg.mla_v_dim * d
                per_layer += q + kv + o
            else:
                per_layer += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
            per_layer += 3 * d * cfg.d_ff
        elif kind == "moe":
            per_layer += d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
            per_layer += d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.expert_ff
        elif kind == "ssm":
            din = cfg.d_inner
            proj_in = d * (2 * din + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads)
            per_layer += proj_in + din * d + cfg.ssm_conv * (din + 2 * cfg.ssm_groups * cfg.ssm_state)
        elif kind == "rglru":
            w = cfg.lru_dim
            per_layer += d * w * 2 + w * d + 2 * w * w // 1 + cfg.conv_width * w  # proj + gates + conv
        per_layer += 2 * d  # norms
    total = emb + per_layer  # pattern already spans all layers
    if cfg.is_encdec:
        enc_layer = d * hd * 2 * (cfg.n_heads + cfg.n_kv_heads) + 2 * d * cfg.d_ff
        total += cfg.encoder_layers * enc_layer
    return total
