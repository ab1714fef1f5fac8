#!/usr/bin/env python3
"""Flash attention on Hopper's tensor cores, against the port's kernel.

    python3 tools/flash_tc/run.py        # from the repository root, one H100

``flash_wgmma.cu`` beside this file is the port's ``flash`` kernel
(``src/repro_torch/kernels/csrc/flash.cu``, float32 FMAs on the CUDA
cores) redesigned for the tensor cores: both products on ``wgmma`` with
float32 accumulators, float32 precision kept by splitting p (and float32
inputs) into three bf16 parts.  It is not the port's kernel: with it
the LM gate of ``chip_smoke.py`` (teacher-forced logits of the flash
model within 2e-2 of the largest plain logit) fails, as it does with
attention in float64 (phase 3 below).  This script builds it from
source (``nvcc`` for ``sm_90a``, no fast math, into ``build/`` beside
this file) and prints one JSON line per phase:

1. ``kernel``: device ms at the LM's prefill shape (64, 1500, 128), bf16,
   causal, for this kernel, the port's kernel and
   ``scaled_dot_product_attention``; this kernel's float32 error against
   ``ref.flash_ref`` (limit 2e-5), the bf16 output against the float32
   kernel rounded once (bitwise), and edge shapes (S, L off the tiles,
   S != L, windows, hd 64).
2. ``rounding``: on bf16 heads of that shape, how many bf16 outputs of
   each attention (this kernel, the port's, the plain ``_sdpa``) differ
   from ``_sdpa``'s and from float64 attention rounded once.
3. ``lm_gate``: ``chip_smoke.py``'s teacher forcing (``qwen2_5_3b`` at
   full width and depth, seed 0, its eight requests) with the flash
   layers run by each of this kernel, the port's kernel and float64
   attention: the largest logit difference over the largest plain
   logit, for each step, against the gate's 2e-2.

Without a CUDA device it exits 2 and prints nothing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

# cuBLAS needs a fixed workspace for torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPE = cs.FLASH_MAIN                       # (B H, S, hd)
HEADS = 16                                  # qwen2_5_3b's query heads
#: (BH, S, L, hd, causal, window): edges of the 64-row and 64-key tiles
EDGES = [(4, 1, 1, 128, True, 0), (4, 63, 63, 64, True, 0),
         (4, 64, 64, 128, True, 0), (4, 65, 65, 128, True, 0),
         (4, 129, 129, 64, True, 0), (4, 65, 200, 64, False, 0),
         (4, 200, 65, 128, True, 0), (4, 256, 256, 64, True, 100),
         (4, 65, 130, 128, True, 40), (2, 31, 33, 64, False, 0)]


def build():
    """Compile flash_wgmma.cu and load it (signature of repro_flash)."""
    from repro_torch.kernels import _build
    out = HERE / "build"
    out.mkdir(exist_ok=True)
    lib = out / "libflash_tc.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
         str(HERE / "flash_wgmma.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out / "build.log").write_text(proc.stdout)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}")
    dll = ctypes.CDLL(str(lib))
    dll.flash_tc.argtypes = _build.SIGNATURES["repro_flash"]
    dll.flash_tc.restype = ctypes.c_int
    return dll


def make_tc(dll):
    from repro_torch.kernels import _build

    def tc(q, k, v, causal=True, window=0):
        o = torch.empty_like(q)
        err = dll.flash_tc(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            q.shape[0], q.shape[1], k.shape[1], q.shape[2],
            int(q.dtype == torch.bfloat16), q.shape[2] ** -0.5, int(causal),
            int(window), _build.stream_of(q))
        if err:
            raise RuntimeError(f"flash_tc launch failed: CUDA error {err}")
        return o
    return tc


def attention64(q, k, v, causal=True):
    """Attention in float64 over folded heads, (BH, S, hd)."""
    S, L, hd = q.shape[1], k.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * hd ** -0.5
    if causal:
        hide = torch.ones(S, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(hide[None], -1e30)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v.double())


def phase_kernel(tc, dev, gen):
    from repro_torch.kernels import flash, ref
    BH, S, hd = SHAPE
    q, k, v = (torch.randn(BH, S, hd, generator=gen).to(dev).bfloat16()
               for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.view(BH // HEADS, HEADS, S, hd) for t in (q, k, v))
    times = {"flash_tc": cs.time_ms(lambda: tc(q, k, v), iters=20),
             "port_flash": cs.time_ms(
                 lambda: flash.flash_attention(q, k, v), iters=20),
             "sdpa": cs.time_ms(lambda: sdpa(q4, k4, v4, is_causal=True),
                                iters=20)}
    q32, k32, v32 = (t[:16].float() for t in (q, k, v))
    err32 = float((tc(q32, k32, v32) - ref.flash_ref(q32, k32, v32))
                  .abs().max())
    bitwise = torch.equal(tc(q, k, v), tc(q.float(), k.float(),
                                          v.float()).bfloat16())
    bad = []
    for bh, s_, L, d, causal, window in EDGES:
        qq, kk, vv = (torch.randn(bh, n, d, generator=gen).to(dev)
                      for n in (s_, L, L))
        kw = dict(causal=causal, window=window)
        e32 = float((tc(qq, kk, vv, **kw) - ref.flash_ref(qq, kk, vv, **kw))
                    .abs().max())
        b = [t.bfloat16() for t in (qq, kk, vv)]
        same = torch.equal(tc(*b, **kw),
                           tc(*(t.float() for t in b), **kw).bfloat16())
        if not (e32 <= cs.KERNEL_TOL and same):
            bad.append([bh, s_, L, d, causal, window, e32, same])
    pairs = S * (S + 1) // 2
    gemm = BH * pairs * hd * 2
    out = {"phase": "kernel", "shape": list(SHAPE), "dtype": "bfloat16",
           "route": "wgmma", "times": times,
           "tensor_core_tflops": gemm * 4 / times["flash_tc"]["device_ms"]
           / 1e9,
           "max_abs_err_fp32": err32, "limit": cs.KERNEL_TOL,
           "bf16_is_fp32_rounded_once": bitwise, "edge_cases_failing": bad}
    cs.emit(out)
    assert err32 <= cs.KERNEL_TOL and bitwise and not bad, out


def phase_rounding(tc, dev, gen):
    from repro_torch.kernels import flash
    from repro_torch.models import attention as A
    BH, S, hd = SHAPE
    B = BH // HEADS
    q, k, v = (torch.randn(B, S, HEADS, hd, generator=gen).to(dev)
               .bfloat16() for _ in range(3))

    def fold(t):
        return t.transpose(1, 2).reshape(BH, S, hd).contiguous()

    fq, fk, fv = fold(q), fold(k), fold(v)
    plain = fold(A._sdpa(q, k, v, A.causal_mask(S, S, 0, 0, dev),
                         A._inv_sqrt(hd)))
    exact = torch.empty_like(fq)
    for h0 in range(0, BH, 8):
        exact[h0:h0 + 8] = attention64(fq[h0:h0 + 8], fk[h0:h0 + 8],
                                       fv[h0:h0 + 8]).bfloat16()
    outs = {"flash_tc": tc(fq, fk, fv),
            "port_flash": flash.flash_attention(fq, fk, fv),
            "plain_sdpa": plain}
    cs.emit({"phase": "rounding", "of": plain.numel(), "differ_from_plain": {
        n: int((o != plain).sum()) for n, o in outs.items()},
        "differ_from_float64_rounded_once": {
        n: int((o != exact).sum()) for n, o in outs.items()}})


def phase_lm_gate(tc, dev):
    from repro_torch.configs import get
    from repro_torch.models import attention as A
    from repro_torch.models import build as build_model
    from repro_torch.serving.lm import Request
    torch.use_deterministic_algorithms(True)
    cfg = get(cs.LM_ARCH).with_(use_flash=True)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0),
                                   device=dev)
    flash_api = build_model(cfg)
    plain_api = build_model(cfg.with_(use_flash=False))
    port = A._flash_sdpa

    def folded(fn):
        def run(cfg_, q, k, v, causal):
            B, S, H, hd = q.shape
            if k.shape[2] != H:
                k = torch.repeat_interleave(k, H // k.shape[2], dim=2)
                v = torch.repeat_interleave(v, H // v.shape[2], dim=2)
            f = [t.transpose(1, 2).reshape(B * H, t.shape[1], hd)
                 .contiguous() for t in (q, k, v)]
            o = torch.empty_like(f[0])
            for h0 in range(0, B * H, 16):     # slabs: float64 is large
                o[h0:h0 + 16] = fn(*(t[h0:h0 + 16] for t in f), causal)
            return o.reshape(B, H, S, hd).transpose(1, 2)
        return run

    reqs = cs._lm_requests(cfg.vocab, Request)
    plain = []
    for b0 in range(0, len(reqs), cs.LM_BATCH):
        tokens = cs._left_padded(reqs[b0:b0 + cs.LM_BATCH], cs.LM_BATCH, dev)
        plain.append((tokens,) + cs._greedy_logits(plain_api, params, tokens,
                                                   cfg.vocab))
    variants = {
        "flash_tc": folded(lambda q, k, v, c: tc(q, k, v, causal=c)),
        "port_flash": port,
        "float64_attention": folded(
            lambda q, k, v, c: attention64(q, k, v, c).to(q.dtype))}
    result = {}
    try:
        for name, fn in variants.items():
            A._flash_sdpa = fn
            steps = []
            for tokens, want, forced in plain:
                got, _ = cs._greedy_logits(flash_api, params, tokens,
                                           cfg.vocab, forced=forced)
                steps += [float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want)]
            result[name] = {"max_rel_logit_err": max(steps),
                            "passes": max(steps) <= cs.LOGIT_TOL,
                            "per_step": steps}
    finally:
        A._flash_sdpa = port
    cs.emit({"phase": "lm_gate", "limit": cs.LOGIT_TOL, **result})


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tc: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tc = make_tc(build())
    gen = torch.Generator().manual_seed(0)
    phase_kernel(tc, dev, gen)
    phase_rounding(tc, dev, gen)
    phase_lm_gate(tc, dev)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
