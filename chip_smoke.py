#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; every check asserts, and any failure exits
non-zero with no result line:

1. ``env``: the card, its power limit, torch / CUDA versions, the TF32
   flags, the time to build the CUDA kernels from ``csrc/``, and the
   launch floor: the time of one PyTorch kernel on one element.
2. ``autotune``: ``kernels.autotune.tuned_blocks`` with a ``measure``
   thunk on the card for each op (``sv_predict``, the RFF and linear
   steps, ``rff``, ``gram``, ``quadform``) at its main path's shape:
   every candidate geometry's output bitwise the default's, the
   search's choice, source and each candidate's time, and a second
   resolution of the key a hit with no new compile.  Then one line per
   kernel: each hand-written kernel against its plain
   PyTorch version on the card, at the engine's shapes and at edge
   shapes (ragged budgets, budget 1, all-padded coefficients, every
   chunk and cluster edge of ``sv_predict`` and the RFF
   ``primal_step``, whose rows must also come out bitwise at every
   batch of ``BATCHES``; ``sv_predict`` timed at B = 8 too), under
   the parity tolerance of tests/conftest.py:42-43 (``rff``, whose
   outputs are bounded by sqrt(2/D), to a thousandth of that bound,
   with a bf16-projection control that must miss it, at every bucket
   size of serving with every row bitwise the one-row call and X 4
   bytes off a 16-byte boundary bitwise X aligned, timed per bucket
   size, its kernels line at M = 64 with the mean weighted by
   ``serve_rff_dynamic``'s launches per bucket size beside it
   (``weighted_*``); the dynamic check's ``ops.rkhs_dist_sq``,
   2m + 1 forms in one ``quadform`` launch, bitwise the 3m-form launch;
   ``flash`` and
   ``gram`` to the JAX package's rtol = atol = 2e-5 in float32, each
   with a TF32 control that must miss it, ``flash`` also with a control
   that rounds p once to bf16 before p.v, as a one-pass bf16 product
   does, on the main path's bf16 inputs, which must miss it while the
   float32 kernel meets it; where its products run and their rate on a
   line of their own; bf16 ``flash`` bitwise the
   float32 kernel's result rounded once, and within 2 bf16 ulps of the
   float32 plain result wherever that ulp is above the float32 limit);
   then its time (CUDA events, after
   warm-up) beside the plain version's time, the least time the card
   could take (``bound_ms``) and, where one PyTorch call computes the
   same function, that call's time (``library_ms``; timed only).
3. end to end: ``engine.run`` at full width on ``susy_stream`` with
   d = 18, T = 1000, under ``backend="kernels"``: SV periodic and SV
   dynamic (m = 32, budget 1024), RFF dynamic (m = 32, D = 2048),
   linear periodic (m = 1024).  Each run must launch its kernels,
   agree with ``backend="reference"`` on the card (same sync rounds and
   bytes, losses and compression errors within tolerance), and repeat
   bitwise; the SV runs must peak under 1 GiB of device memory (their
   syncs hold no (m tau)^2 Gram).
4. serving: ``serving.serve_stream`` on the same streams and learners
   (RFF dynamic and SV dynamic under continuous batching with a
   shedding queue, linear periodic on the tick grid), about 16,000
   requests each.  Each run must launch its kernels, have the protocol
   view of phase 3's ``engine.run`` bitwise, the serving face of a
   ``backend="reference"`` serving run exactly and its predictions
   within the parity pair, repeat bitwise, and answer every bucket
   size's rows as ``predict_one`` does, bitwise, and as the plain
   stacked ``predict`` does, within the parity pair.  Then the same
   row checks below the kernels' threshold (SV budget 64, RFF D = 64).
5. ``gram_path``: ``ops.gram_spec`` on the SV sync's shape (m tau =
   32768 SUSY rows, d = 18, gaussian); it must launch ``gram`` and
   agree with the plain version within 2e-5, which a TF32 cross term
   must miss (the ``gram`` kernel line times this shape only).  And
   ``sync_route`` (run before phase 3, ahead of the serving runs' long
   profiles, after which the profiler has lost whole windows of its
   ms-long calls): the sync's ``compression.truncate`` at that shape
   under ``backend="kernels"`` (one ``quadform``, no Gram) against
   ``backend="reference"``: the same model bitwise, epsilon within the
   parity pair; and epsilon^2 by the quadform, gram and plain routes,
   each timed with its peak memory.
6. ``lm_serve``: ``serving.lm.LMServingEngine`` with ``qwen2_5_3b`` at
   full width and depth (36 layers, bf16, ``use_flash=True``, weights
   drawn on the card from seed 0), batch 4, max_len 2048, eight
   requests of 32 new tokens with prompts of (1500, 1200, 700, 333) and
   (1024, 900, 512, 64) tokens.  It must launch ``flash`` once per
   layer and prefill (72) and repeat bitwise.  Then the same requests
   with deterministic algorithms off, as a user runs them: tokens per
   wall second, prefill and decode seconds (CUDA events around each
   call, no synchronize added), and from a profiled run the kernels,
   device time and span of every step.  Last, teacher forcing against
   the same model on the plain attention (``use_flash=False``): every
   flash layer's output within 2 bf16 ulps (plus 2e-5) of the plain
   ``_sdpa`` on the same post-RoPE q, k, v; prefill and decode logits
   within 2e-2 of the largest logit (tests/test_decode.py:37); tokens
   equal wherever the plain run's top-2 margin exceeds twice the row's
   measured difference.

7. ``async``: ``runtime.run_async_simulation`` on phase 3's learners
   and stream: ``async_sv_dynamic`` (ideal network, alpha 1, its depth
   cut to ``ASYNC_T_SV``), ``async_rff_wan`` (examples/async_susy.py's
   lossy WAN, poly staleness) and ``async_linear_periodic`` (m = 1024,
   depth cut to ``ASYNC_T_LINEAR``).  Each run must launch its kernels
   (``sv_predict`` and ``quadform``; ``rff``), repeat bitwise in every
   field, and the SV and RFF runs equal ``backend="reference"`` on the
   card in sync rounds, bytes, the event clock's face and staleness,
   losses within the parity pair; the SV run equals ``sv_dynamic``'s
   ledger over its rounds (the zero-latency contract) and peaks under
   1 GiB (an aggregate holds no Gram of its 2 n tau slots); the linear
   run syncs every 10 rounds at ``sync_bytes_linear`` each.  Before the
   runs, ``node_shapes`` times the kernels at a node's shapes:
   ``sv_predict`` at B = 1, the node's check (3 forms of 1024^2, bitwise
   three one-form launches) and the aggregate's 65,536^2 form.

8. ``sweep``: ``engine.sweep`` on phase 3's learners and stream, each
   grid's configs stacked on one axis of n m rows (one round launch a
   round): ``sweep_sv_dynamic`` (``SV_SWEEP``: delta 8 to 64 x
   mini_batch 5, 10), ``sweep_rff_dynamic`` (``RFF_SWEEP``: delta 2.25
   to 18 x mini_batch 5, 10) and ``sweep_linear_mixed`` (m = 1024:
   periodic 50, periodic 10, dynamic 0.1 / 10, continuous).  Anchor
   rows equal phase 3's runs bitwise in every field (the SV (16, 10),
   RFF (9, 10) and periodic-50 rows), and two more SV rows (delta 64 /
   mini_batch 5 and the row with the most syncs) their solo
   ``engine.run``; every grid equals ``backend="reference"`` on the
   card in sync rounds and bytes, floats within the parity pair, and a
   repeat bitwise; the SV sweep peaks under 1 GiB.  Before
   the runs, ``slice_shapes`` times the kernels at these shapes:
   ``sv_predict`` at B = 256, the grouped check (8 configs' 2m + 1
   forms of 1024^2 in one launch, each bitwise its own launch), the
   RFF step at B = 256 and the linear step at B = 10^5, D = 4.
9. ``population``: ``population.run_population`` at
   benchmarks/bench_population.py's scale (linear hinge, d = 4,
   ``separable_stream(seed=0, margin=0.5)``): 100,000 learners at
   sample rates 0.1, 0.5, 1.0 (periodic 3, T = 40; every byte column
   equal to the closed-form Sec. 3 oracle, bytes rising strictly with
   the rate, ``monitor_population``'s byte series integer-exact, the
   rate-1.0 run bitwise ``engine.run``), the default class mix under
   churn (dynamic delta 200), 10^6 learners (T = 6); then phase 3's SV
   learners under churn (``PopulationSpec(m_total=32, sample_rate=0.8,
   seed=3)``, T = 1000) under ``sv_dynamic``'s and ``sv_periodic``'s
   protocols, each against ``backend="reference"``: equal sync rounds,
   bytes and rejoin bytes, floats within the parity pair, a repeat
   bitwise, an all-True mask bitwise its phase 3 run, peak under 1 GiB.

10. ``mesh``: ``launch.mesh.make_learner_mesh(devices=["cuda:0"] * n)``
   on phase 3's learners and stream, the shards on the one card:
   ``engine.run(mesh=)`` for ``mesh_sv_dynamic`` at 2 and 4 shards,
   ``mesh_sv_periodic``, ``mesh_rff_dynamic`` and
   ``mesh_linear_periodic`` at 4 (m = 1024, 256 a shard), each bitwise
   its phase 3 run in every field (the SV runs peaking under 1 GiB);
   ``mesh_sv_dynamic`` again under ``topology="allreduce"`` (the same
   sync rounds, each at the ring bytes) and a bitwise repeat (the
   card's busy share from a window, launches a shard);
   ``engine.sweep(mesh=)`` on the RFF sweep's grid (each row bitwise the single-device sweep's,
   one step launch a shard a round); ``run_population(mesh=)`` at
   10^5 linear learners and sample rate 0.5 (bitwise the single-device
   masked run, bytes equal to the closed-form Sec. 3 oracle);
   ``serve_rff_dynamic`` with 2 slots a shard (its ``sim`` bitwise the
   unmeshed serve's, every shard's bucket rows bitwise ``predict_one``).
   With more than one card, ``mesh_sv_dynamic`` with one shard a card
   too.  Before the runs, ``mesh_shapes`` times the kernels at a
   shard's shapes: ``sv_predict`` at B = 8, the 17-form check and
   ``rkhs_dist_sq_each``'s 24 forms (bitwise the check), the RFF step at
   B = 8 and the linear step at B = 256.
11. ``oracle``: ``simulation.run_kernel_simulation`` at ``sv_dynamic``'s
   config and ``run_linear_simulation`` at ``linear_periodic``'s on the
   card (in the second process, beside phase 7's linear repeat): sync rounds and bytes equal to phase 3's runs, losses and
   compression errors within the parity pair; the SV oracle's plain
   compression builds the (m tau)^2 Gram, whose peak is reported.
12. ``train``: the LM protocol trainer (``launch.train``) with
   ``qwen2_5_3b`` at full width and depth (36 layers, d 2048, bf16,
   ``use_flash=False``, weights drawn on the card from seed 0 after
   ``lm_serve`` freed its own), m = 2 learners of 1 x 256 tokens a
   round from ``token_stream(seed=0)``, sgd (lr 0.05, momentum 0, clip
   1.0): ``train_periodic`` (period 4) and ``train_dynamic`` (mini_batch
   1, delta the geometric mean of the first round's and the largest
   pre-sync distance ``train_periodic`` recorded), T = 8 each.  After
   every sync each learner's parameters are bitwise equal and the
   reference is bitwise their float32 average; after a quiet round the
   reference is bitwise unchanged; ``syncs`` and ``bytes_sent`` equal a
   host recount (float32, as the carry); every loss is finite; each run
   repeats bitwise from seed 0 (deterministic algorithms on); no CUDA
   kernel of the port launches; peak memory under the card's.  Then
   ``TRAIN_TIMED_T`` rounds timed with CUDA events, with deterministic
   algorithms on and then off, and with the mode off one by
   ``telemetry.probe.time_fn`` and one profiled (the busy share); the
   smoke model in float32 on the card against the CPU from one state
   (adamw with ``continuous``, sgd momentum 0.9 with per-group
   ``dynamic``: equal sync counts and bytes, losses and parameters
   within the parity pair); benchmarks/bench_adaptive.py's five configs
   through ``protocol.make_protocol_step`` on the card and on the CPU
   (equal syncs and bytes); a bf16 smoke ``TrainState`` through
   ``checkpoint.save_step`` / ``restore``, bitwise; and under
   ``telemetry.CompileCounter`` a second value-equal ``engine.run`` of
   ``sv_dynamic`` and a second ``engine.sweep`` of the RFF grid, each
   adding no compile.
13. ``lm_ssm``: ``mamba2_130m`` at full width and depth (24 layers, d
   768, bf16 with float32 ``A_log``, ``D`` and ``dt_bias``; 129,100,224
   parameters, 258,203,904 B; weights drawn on the card from seed 0
   after phase 12 freed its own).  The trainer with m = 4 learners of 2
   x 512 tokens a round (four chunks of 128) from ``token_stream(seed=0)``,
   sgd (lr 0.05, momentum 0, clip 1.0): ``train_periodic`` (period 4)
   and ``train_dynamic`` (delta as phase 12 picks it), T = 8 each,
   under phase 12's checks (``_ProtocolWatch``, the host recount of
   the bytes: each sync 2,065,631,232 B, the reference's own formula, a
   bitwise repeat, no kernel of the port) and every gradient finite,
   ``A_log``'s, ``D``'s and ``dt_bias``'s included (``_GradWatch``);
   then ``SSM_TIMED_T`` rounds timed with deterministic algorithms on
   and off and one profiled.  ``LMServingEngine`` on ``LM_PROMPTS`` at
   batch 4, 32 new tokens (the 1500-token batch pads to 1536 inside the
   scan): a repeat bitwise, no kernel launched, tokens per wall second,
   prefill and decode seconds and device activities a decode step.
   The same weights in float32: prefill of 1500 tokens, then 31
   teacher-forced decode steps, each within 2e-2 of the largest logit
   of one full forward (tests/test_decode.py:37).
14. ``lm_dense``: ``granite_8b`` (36 layers, 32/8 heads) and then
   ``qwen3_14b`` (40 layers, 40/8 heads, ``qk_norm``), hd 128, bf16,
   ``use_flash=True``, full width and depth from seed 0, one at a time:
   ``LMServingEngine`` at batch 4 on prompts of 1024, 700, 333 and 64
   tokens, 8 new tokens, one ``flash`` launch a layer, every flash
   layer within 2 bf16 ulps (plus 2e-5) of ``_sdpa`` on its own q, k,
   v, a repeat bitwise, then served with deterministic algorithms off
   (tokens per wall second, peak memory); ``flash`` timed at each
   prefill's shape (the ``flash`` kernels entry's ``lm_dense_shapes``).

15. ``lm_long``: ``recurrentgemma_9b`` at full width and depth (38
   layers, d 4096, (rglru, rglru, attn) units with local attention of
   window 2048, MQA hd 256, bf16 with float32 ``Lambda``; 9,396,408,320
   parameters; weights drawn on the card from seed 0 after phase 14
   freed its own): ``LMServingEngine`` at batch 4, max_len 4096, prompts
   of 64, 700, 2,100 and 3,000 tokens (the 3,000-token prefill takes the
   ring path), 32 new tokens, under ``_serve_checked`` (a repeat
   bitwise, no kernel launched, tokens per wall second, prefill and
   decode seconds, device activities a decode step); the
   ``decode_32k`` shape (``make_decode_step`` at batch 128, caches of
   ``input_specs``' shapes and dtypes, 3,357,638,656 B, filled by a
   prefill of 128-token prompts, 8 steps with finite logits twice
   bitwise, then timed); the same weights in float32, a 2,100-token
   prefill and 16 teacher-forced decode steps within 2e-2 of the
   largest logit of one windowed full forward; ``variant_for(qwen2_5_3b,
   "long_500k")`` (window 4096, ``use_flash=True``) in float32, a
   6,000-token prefill and 32 steps held the same way, its caches of
   ``input_specs``' shapes, no ``flash`` launch; the trainer at full
   width and depth cut to 3 layers, m = 2 x 2,304 tokens, periodic
   (period 2) and dynamic, T = 4, under phase 12's checks.
16. ``lm_vlm``: ``qwen2_vl_2b`` at full width and depth (28 layers, d
   1536, 12 heads over 2 kv heads of 128, M-RoPE sections (16, 24, 24),
   bf16, ``use_flash=True``; 1,543,910,912 parameters; weights drawn on
   the card from seed 0 after phase 15 freed its own): at batch 4, each
   sample 1,024 seeded patch embeddings and 300 tokens (S 1,324), the
   model API's prefill and 16 greedy decode steps at positions 1,324
   onward (``LMServingEngine.run``'s loop: the engine takes no
   ``embeds``), one ``flash`` launch a layer, every flash layer within 2
   bf16 ulps (plus 2e-5) of ``_sdpa`` on its own M-RoPE-rotated q, k, v,
   a repeat bitwise in tokens and logits, then timed with deterministic
   algorithms off (tokens per wall second, prefill seconds, ms a decode
   step, device activities a decode step, peak memory); ``flash`` timed
   at that prefill's shape (the ``flash`` entry's ``lm_vlm_shapes``);
   one full-width layer's ``gqa_forward`` with distinct streams
   (positions (3, 1, 1,324)) on the card against the CPU in float32;
   the same weights in float32, the prefix and 300 tokens prefilled and
   16 teacher-forced decode steps within 2e-2 of the largest logit of
   one full forward; the trainer at full width cut to 4 layers, m = 2 x
   (1,024 embeddings + 256 tokens), periodic (period 2) and dynamic, T
   = 4, under phase 12's checks.
17. ``lm_mla``: ``minicpm3_4b`` at full width and depth (62 layers, d
   2560, 40 heads, MLA with q_lora 768, kv_lora 256, nope 64, rope 32,
   v 64, bf16; 4,073,937,408 parameters; weights from seed 0 after phase
   16 freed its own): ``LMServingEngine`` at batch 4 on prompts of 1,024,
   700, 333 and 64 tokens, 32 new tokens, under ``_serve_checked`` (a
   repeat bitwise, no kernel of the port launched); the latent cache's
   576 B a token a layer beside a 40-head K/V cache's 12,800 B; the
   same weights in float32, a 1,024-token prefill and 16 teacher-forced
   decode steps within 2e-2 of one full forward, the first step's
   absorbed decode in every layer within rtol 1e-4, atol 1e-5 of the
   naive one; the trainer at full width cut to 3 layers, m = 2 x 1,024
   tokens, periodic and dynamic, T = 4, under phase 12's checks.
18. ``lm_moe``: ``olmoe_1b_7b`` (16 layers, d 2048, 16 heads of 128,
   ``qk_norm``, 64 experts of 1,024, top 8; 6,919,624,704 parameters)
   and then ``granite_moe_1b_a400m`` (24 layers, d 1024, 16 heads over 8
   kv heads of 64, 32 experts of 512, top 8, tied; 1,334,887,424), bf16,
   ``use_flash=True``, capacity factor 1.25 in groups of 256, full width
   and depth from seed 0 after phase 17 freed its own, one at a time:
   ``LMServingEngine`` at batch 4 on prompts of 1,024, 700, 333 and 64
   tokens, 32 new tokens, under ``_serve_checked`` (one ``flash`` launch
   a layer, a repeat bitwise), every flash layer within 2 bf16 ulps
   (plus 2e-5) of ``_sdpa`` on its own q, k, v, each prefill layer's
   dropped assignments counted (``_DropWatch``); ``flash`` timed at the
   prefill's shape (the ``flash`` entry's ``lm_moe_shapes``; hd 64 for
   ``granite_moe_1b_a400m``); the weights in float32 with capacity
   factor E / K (nothing can drop: every grouped call keeps all T K
   assignments), a 512-token prefill and 16 teacher-forced decode steps
   (the dense, capacity-free form) within 2e-2 of the largest logit of
   one full forward, at 4 layers for ``olmoe_1b_7b`` and full depth for
   ``granite_moe_1b_a400m``; ``olmoe_1b_7b``'s trainer at 3 layers, m = 2
   x 512 tokens, T = 4, under phase 12's checks, the aux loss nonzero.
19. ``lm_audio``: ``whisper_large_v3`` at full width and depth (32
   encoder and 32 decoder layers, d 1280, 20 heads of 64, LayerNorm,
   GELU, bf16, ``use_flash=False``, the config's: the reference refuses
   a non-causal flash at 1,500 frames; 1,545,835,520 parameters; weights
   from seed 0 after phase 18 freed its own): batch 4 of 1,500 seeded
   frame embeddings (the reference's stub frontend) and 4-token decoder
   prompts through ``launch/serve.py``'s ``make_prefill_step`` and 31
   greedy ``make_decode_step`` calls (caches of 448 slots; the
   reference's LM engine builds no ``frames``), no kernel of the port
   launched, a repeat bitwise, then timed with deterministic algorithms
   off; the first encoder layer in float32 on the card against the CPU;
   the same weights in float32, a 4-token prefill and 31 teacher-forced
   decode steps within 2e-2 of the largest logit of ``decode_train``;
   the trainer at 4 + 4 layers, m = 2 x (1,500 frames + 256 tokens), T =
   4, under phase 12's checks.
20. ``launch``: the dry run (``launch/dryrun.py``, no card) over the
   single-pod mesh (data 16 x model 16) for one architecture per family
   (``LAUNCH_ARCHS``) at the four shapes, 24 records counted on ``meta``
   tensors in one spawned process a CPU core (the 40 of ``--all``
   are the README's command); then the ``long_500k`` decode step of
   ``qwen2_5_3b`` (its window variant: a ring of 4,096 slots) and of
   ``mamba2_130m`` at full width on the card, B 1, bf16 weights drawn
   on the card from seed 0: one step under ``FlopCounterMode`` counts
   exactly the record's ``flops_global``, the parameters, caches, token
   and position allocated on the card hold exactly its
   ``argument_size_global`` bytes, the next token lies in the
   vocabulary, no kernel of the port launched; the step's CUDA-event
   time (the median of ``LAUNCH_ITERS`` after warm-up) beside
   ``roofline.analyze_record``'s compute and memory terms for one H100
   at the same global counts, and where the step's time goes:
   ``LAUNCH_BUSY_STEPS`` steps' wall and device ms, CUDA activities and
   busy share, unprofiled and profiled (``_launch_busy``).

Every run phase reads the card's busy share and top kernels over a
window, the run's first twentieth of rounds run again unprofiled for its
wall time and profiled for its device time (``busy_window`` on the
line); its bitwise repeat runs unprofiled.

The last lines are the card's ``nvidia-smi`` name and power limit, the
``kernels`` summary (with each kernel's ``slice_shapes`` and
``mesh_shapes`` numbers, ``flash``'s LM prefill shapes and the SV
sweep's grouped check sizes), and
``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the repository's ``src/`` beside this file, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS needs a fixed workspace before CUDA initializes for
# torch.use_deterministic_algorithms(True)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# THE parity tolerance of the repository (tests/conftest.py:42-43).
PARITY_RTOL = 1e-3
PARITY_ATOL = 5e-3
# rff's outputs are bounded by sqrt(2/D) (0.031 at D = 2048), far below
# the parity pair's atol: it is held to a thousandth of that bound
RFF_ATOL_OF_SCALE = 1e-3
# flash and gram: the JAX package's own kernel tolerance in float32
# (tests/test_kernels_pallas.py); bf16 flash within 2 bf16 ulps where
# that ulp is above the float32 limit (near 0 the plain version's own
# float32 rounding exceeds a bf16 ulp)
KERNEL_TOL = 2e-5
BF16_ULPS = 2
# the LM's logits: tests/test_decode.py:37, of the largest logit
LOGIT_TOL = 2e-2

# time_ms's lead-in on a retried profiler window: about 0.1 s of one
# spinning thread at the H100's 1.98 GHz
LEAD_IN_CYCLES = 200_000_000

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12     # bf16 tensor cores, fp32 accumulation

T_ROUNDS = 1000
D_IN = 18                 # SUSY's 18 features
GAMMA = 0.05
M_KERNEL = 32             # learners of the SV and RFF runs
BUDGET = 1024             # SV budget tau
N_FEATURES = 2048         # RFF features D
M_LINEAR = 1024           # learners of the linear run
GRAM_M = M_KERNEL * BUDGET   # the SV sync's Gram: m tau rows

# The LM serving phase: the shape of the main path's flash launches
LM_ARCH = "qwen2_5_3b"
LM_BATCH = 4
LM_MAX_LEN = 2048
LM_NEW_TOKENS = 32
LM_PROMPTS = (1500, 1200, 700, 333, 1024, 900, 512, 64)
FLASH_MAIN = (LM_BATCH * 16, 1500, 128)    # (B H, S, hd) of the first batch
# gram's edges: M and N across its 64-row and 128-column tiles and its
# 16-byte stores, d across its chunks of 32 features
GRAM_SIDES = [1, 127, 129, 130, 4097]
GRAM_D = [1, 17, 18, 31, 32, 33, 64]
# an SV run's peak device memory under backend="kernels": the sync no
# longer holds the (m tau)^2 Gram (4.3 GB)
SV_PEAK_LIMIT = 1 << 30


# A kernel redesigned for Hopper, and what its earlier design took at the
# same shape (this script, on an H100 80GB HBM3 at 700 W): the earlier
# values its line reports.
EARLIER = {
    "quadform": {"design": "one column and 32 rows a thread, a shared-"
                 "memory load per FMA", "ms": 0.4035, "device_ms": 0.3991},
    "sv_predict": {"design": "one block of 128 threads per row, each thread "
                   "reading its slots' 18-float rows 72 bytes apart from "
                   "device memory, then a 7-step barrier tree",
                   "ms": 0.02142848014831543,
                   "device_ms": 0.011023800000000049},
    "primal_step_rff": {"design": "one block of 256 threads per learner, W "
                        "rows read 72 bytes apart from device memory, "
                        "every feature computed twice, a barrier tree and "
                        "thread 0 alone on the loss",
                        "ms": 0.061098880767822265,
                        "device_ms": 0.01649204000000005},
    "primal_step_linear": {"design": "a block of 32 threads per learner at "
                           "D = 18: x staged in shared memory behind a "
                           "barrier, a five-barrier shared-memory tree, "
                           "thread 0 alone on the loss",
                           "ms": 0.05463, "device_ms": 0.002671},
    "gram": {"design": "one short-lived block of 128 threads per 32 x 128 "
             "tile, 4-byte stores, the kind a runtime branch per element",
             "ms": 3.6429, "device_ms": 3.6521, "linear_ms": 2.978},
    # at M = 64; by bucket size: tools/kernel_probe.py rff on the earlier
    # tree
    "rff": {"design": "one thread a column in blocks of 256 columns and 4 "
            "rows (8 blocks at M <= 4, 64 at M = 32), W and X read from "
            "device memory inside a run-time feature loop",
            "ms": 0.026842880249023437, "device_ms": 0.0030975799999999345,
            "device_ms_by_bucket": {
                "1": 0.002610800000000013, "2": 0.0027526999999999907,
                "4": 0.002922280000000037, "8": 0.0029498799999999846,
                "16": 0.002969700000000023, "32": 0.0029943400000000137,
                "64": 0.0030949399999999857}},
}

# row counts at which each row of sv_predict and primal_step must come
# out bitwise as in a 64-row call
BATCHES = (1, 2, 3, 4, 8, 16, 32, 33, 64)
# serving's bucket sizes (serving/engine.py DEFAULT_BUCKETS): the row
# counts of every rff launch on the main path
RFF_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


#: the script's start (``time.perf_counter``), set by ``main``
STARTED = None


def emit(obj) -> None:
    """One JSON line; a phase line also gets the seconds since the
    script's start (``elapsed_s``), the budget's record."""
    if STARTED is not None and "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - STARTED)
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak of the units that can do them
    (by default fp32 operations on the CUDA cores)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flops_per_s * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> dict:
    """Time ``fn`` on the card after ``warmup`` calls.

    ``ms``: CUDA events around ``iters`` back-to-back calls, over
    ``iters`` -- what one call costs the main path, host enqueue
    included (for a launch-bound kernel the host sets it);
    ``device_ms``: the summed durations of the CUDA kernels one call
    launched, from ``torch.profiler``: each kernel name's mean duration
    times the launches of that name a call makes.  The profiler can lose
    an event or two at a window's edge (seen for 3 us kernels): a name
    whose count is within two of a whole number of launches per call
    keeps its mean.  It can also miss every kernel of a window's first
    10 to 30 ms or more (seen after the serving runs' long profiles, on
    the sync routes' ms-long calls, in this script's run of the parent
    tree too; ``sync_route`` now runs before those profiles): a window
    that lost more is profiled again, up to four times,
    each opening with a ~0.1 s spin kernel and a short one as a marker,
    and counting only the kernels after the marker; then it raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if attempt:
                torch.cuda._sleep(LEAD_IN_CYCLES)
                torch.cuda._sleep(10_000)        # the marker, ~5 us
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if attempt:
            marks = [e for e in kernels if "spin_kernel" in e.name]
            after = max((e.time_range.start for e in marks), default=None)
            kernels = [] if after is None else [
                e for e in kernels if "spin_kernel" not in e.name
                and e.time_range.start > after]
        by_name = collections.defaultdict(list)
        for e in kernels:
            by_name[e.name].append(e.time_range.elapsed_us())
        per_call = {name: round(len(us) / iters)
                    for name, us in by_name.items()}
        if by_name and all(per_call[name] > 0 and
                           abs(len(us) - per_call[name] * iters) <= 2
                           for name, us in by_name.items()):
            break
    else:
        kinds = collections.Counter(str(e.device_type)
                                    for e in prof.events())
        raise RuntimeError(f"the profiler recorded "
                           f"{sum(map(len, by_name.values()))} kernels "
                           f"for {iters} calls (events by device: "
                           f"{dict(kinds)}; by name: "
                           f"{ {k: len(v) for k, v in by_name.items()} })")
    device_us = sum(per_call[name] * sum(us) / len(us)
                    for name, us in by_name.items())
    return {"ms": ms, "device_ms": device_us / 1e3}


def close(got, want, label: str, rtol: float = PARITY_RTOL,
          atol: float = PARITY_ATOL) -> float:
    got = got.detach().cpu().numpy()
    want = want.detach().cpu().numpy()
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.all(np.isfinite(got)), f"{label}: non-finite kernel output"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def excess(got, want, rtol: float, atol: float, rows: int = 2048):
    """(largest |got - want|, elements outside atol + rtol |want|),
    computed on the card in slabs of ``rows`` (a 32768^2 Gram does not
    fit the host's comparison)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    worst, bad = 0.0, 0
    for i in range(0, max(got.shape[0], 1), rows):
        g, w = got[i:i + rows].float(), want[i:i + rows].float()
        assert bool(torch.isfinite(g).all()), "non-finite kernel output"
        err = (g - w).abs()
        if err.numel():
            worst = max(worst, float(err.max()))
            bad += int((err > atol + rtol * w.abs()).sum())
    return worst, bad


def close_dev(got, want, label: str, rtol: float, atol: float) -> float:
    worst, bad = excess(got, want, rtol, atol)
    assert bad == 0, f"{label}: {bad} elements outside rtol {rtol} / " \
        f"atol {atol} (max err {worst})"
    return worst


def bf16_ulp(w: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |w| (w float32, already bf16)."""
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def rows_independent_of_batch(fn, label: str) -> None:
    """``fn(B)`` -> a tensor (or tuple of tensors) of B rows, computed on
    the first B rows of fixed inputs: each row must equal the 64-row
    call's bitwise at every B of ``BATCHES``, and a repeat must equal
    the first call."""
    full = fn(max(BATCHES))
    full = full if isinstance(full, tuple) else (full,)
    again = fn(max(BATCHES))
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(full, again)), \
        f"{label}: a repeat differs"
    for B in BATCHES:
        got = fn(B)
        got = got if isinstance(got, tuple) else (got,)
        for g, f in zip(got, full):
            assert torch.equal(g, f[:B]), f"{label}: rows differ at B={B}"


def check_sv_predict(fused, ref, dev, gen):
    kinds = ["gaussian", "linear", "poly"]
    # the engine's shape, then every chunk and cluster edge of the
    # geometry (128 slots a block, 8 blocks a cluster, 128-slot tiles)
    cases = [(32, 1024), (32, 1), (32, 127), (32, 128), (32, 129),
             (32, 1000), (3, 130), (5, 1023), (5, 1025), (5, 4096),
             (5, 4097)]
    errs = {}
    for kind in kinds:
        for B, N in cases:
            X = torch.randn(B, D_IN, generator=gen).to(dev)
            SV = torch.randn(B, N, D_IN, generator=gen).to(dev)
            A = torch.randn(B, N, generator=gen).to(dev)
            A = A * (torch.rand(B, N, generator=gen).to(dev) < 0.8)
            for label, a in (("", A), (" padded", torch.zeros_like(A))):
                kw = dict(kind=kind, gamma=GAMMA)
                err = close(fused.sv_predict(X, SV, a, **kw),
                            ref.sv_predict_ref(X, SV, a, **kw),
                            f"sv_predict {kind} B={B} N={N}{label}")
                if (B, N) == (32, 1024) and not label:
                    errs[kind] = err
            # a row's floats do not depend on the batch around it
            one = fused.sv_predict(X[1:2], SV[1:2], A[1:2], kind=kind,
                                   gamma=GAMMA)
            assert torch.equal(one[0], fused.sv_predict(
                X, SV, A, kind=kind, gamma=GAMMA)[1]), "row-bitwise"
    for N in (BUDGET, BUDGET + 1):
        X = torch.randn(max(BATCHES), D_IN, generator=gen).to(dev)
        SV = torch.randn(max(BATCHES), N, D_IN, generator=gen).to(dev)
        A = torch.randn(max(BATCHES), N, generator=gen).to(dev)
        rows_independent_of_batch(
            lambda B: fused.sv_predict(X[:B], SV[:B], A[:B], kind="gaussian",
                                       gamma=GAMMA), f"sv_predict N={N}")
    B, N = 32, 1024
    X = torch.randn(B, D_IN, generator=gen).to(dev)
    SV = torch.randn(B, N, D_IN, generator=gen).to(dev)
    A = torch.randn(B, N, generator=gen).to(dev)
    kw = dict(kind="gaussian", gamma=GAMMA)
    ms = time_ms(lambda: fused.sv_predict(X, SV, A, **kw))
    plain = time_ms(lambda: ref.sv_predict_ref(X, SV, A, **kw))
    # serving's commonest bucket
    b8 = time_ms(lambda: fused.sv_predict(X[:8], SV[:8], A[:8], **kw))
    nbytes = 4 * (B * D_IN + B * N * D_IN + B * N + B)
    flops = B * N * (4 * D_IN + 8)      # cross, yy, the gaussian, a * k
    return errs, dict(ms, ms_b8=b8["ms"], device_ms_b8=b8["device_ms"]), \
        plain, bound_ms(nbytes, flops)


def check_autotune(fused, rffmod, grammod, qf, dev, gen) -> dict:
    """``autotune.tuned_blocks`` with a ``measure`` thunk on the card for
    each op at its main path's shape: every candidate's output bitwise
    the default geometry's (the search itself also holds each to the
    first); the search's choice, source and each candidate's time (the
    resolver's ``time_fn``, host clock, waited for); a second resolution
    of the key a hit that compiles nothing.  Returns the phase line's
    ``ops`` object; the kernel checks after it launch with the resolved
    geometries."""
    from repro_torch.kernels import autotune
    from repro_torch.telemetry import CompileCounter

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    B, N, D, M = M_KERNEL, BUDGET, N_FEATURES, 64
    X, SV, A = randn(B, D_IN), randn(B, N, D_IN), randn(B, N)
    (Xs, ys, ws, bs), rkw = _step_args(B, D, D_IN, True, dev, gen)
    (Xl, yl, wl, bl), _ = _step_args(M_LINEAR, D_IN, D_IN, False, dev, gen)
    Xr, Wr, br = randn(M, D_IN), randn(D, D_IN), randn(D)
    Xg = randn(GRAM_M, D_IN)
    Xq, aq = randn(96, N, D_IN), randn(96, N)
    kw = dict(kind="gaussian", gamma=GAMMA)
    cases = {
        "sv_predict": ((N, D_IN), f"gaussian:d={D_IN}", lambda blk:
                       fused.sv_predict(X, SV, A, block_n=blk[0], **kw)),
        "rff_step": ((D,), f"d={D_IN}:D={D}:hinge", lambda blk:
                     fused.primal_step(Xs, ys, ws, bs, block_m=blk[0],
                                       **rkw)),
        "linear_step": ((D_IN,), f"d={D_IN}:D={D_IN}:hinge", lambda blk:
                        fused.primal_step(Xl, yl, wl, bl, block_m=blk[0])),
        "rff": ((M, D), f"d={D_IN}", lambda blk:
                rffmod.rff(Xr, Wr, br, block_m=blk[0], block_d=blk[1])),
        "gram": ((GRAM_M, GRAM_M), f"gaussian:d={D_IN}", lambda blk:
                 grammod.gram(Xg, Xg, block_m=blk[0], block_n=blk[1], **kw)),
        "quadform": ((N, N), f"gaussian:d={D_IN}", lambda blk:
                     qf.quadform(Xq, Xq, aq, aq, block_m=blk[0],
                                 block_n=blk[1], **kw)),
    }
    autotune.clear_cache()
    out = {}
    for op, (dims, kind, measure) in cases.items():
        default = measure(autotune.default_blocks(op, dims))
        cands = autotune.candidates_for(op, dims)
        for blocks in cands:
            got = measure(blocks)
            for g, d in zip(got if isinstance(got, tuple) else (got,),
                            default if isinstance(default, tuple)
                            else (default,)):
                assert torch.equal(g, d), \
                    f"autotune: {op} {dims} {blocks} is not bitwise the default"
        del default
        with CompileCounter() as search:
            blocks = autotune.tuned_blocks(op, dims, kind=kind,
                                           measure=measure)
        choice = autotune.cache_info()[(op, dims, "float32", kind)]
        with CompileCounter() as hit:
            again = autotune.tuned_blocks(op, dims, kind=kind,
                                          measure=measure)
        assert again == blocks and hit.compiles == 0, (op, hit.events)
        assert choice.source == "search" and len(choice.times_ms) == \
            len(cands), choice
        out[op] = {"dims": list(dims), "kind": kind,
                   "default": list(autotune.default_blocks(op, dims)),
                   "choice": list(blocks), "source": choice.source,
                   "candidates": len(cands), "bitwise_default": True,
                   "times_ms": {"x".join(map(str, b)): ms
                                for b, ms in choice.times_ms},
                   "search_compiles": search.compiles,
                   "hit_compiles": hit.compiles}
        torch.cuda.empty_cache()
    return out


def check_quadform(qf, ops, ref, dev, gen):
    kinds = ["gaussian", "linear", "poly"]
    # (P, M, N, d): the engine's shape, the edges, and M, N off the
    # kernel's 64-row and 128-column tiles at one feature, one chunk of 32
    # and two
    cases = [(96, 1024, 1024, D_IN), (3, 1, 1, D_IN), (3, 31, 130, D_IN),
             (3, 127, 129, D_IN), (3, 128, 128, D_IN), (3, 130, 31, D_IN),
             (2, 1000, 1000, D_IN), (3, 63, 65, 1), (3, 65, 129, 33),
             (2, 129, 127, 33)]
    errs = {}
    for kind in kinds:
        for P, M, N, d in cases:
            X = torch.randn(P, M, d, generator=gen).to(dev)
            Y = torch.randn(P, N, d, generator=gen).to(dev)
            a = torch.randn(P, M, generator=gen).to(dev)
            b = torch.randn(P, N, generator=gen).to(dev)
            for label, aa in (("", a), (" padded", torch.zeros_like(a))):
                kw = dict(kind=kind, gamma=GAMMA)
                err = close(qf.quadform(X, Y, aa, b, **kw),
                            ref.quadform_ref(X, Y, aa, b, **kw),
                            f"quadform {kind} P={P} M={M} N={N} d={d}"
                            f"{label}")
                if (P, M) == (96, 1024) and not label:
                    errs[kind] = err
    dist = check_dist_check(ops, qf, dev, gen)
    P, M, N = 96, 1024, 1024
    X = torch.randn(P, M, D_IN, generator=gen).to(dev)
    Y = torch.randn(P, N, D_IN, generator=gen).to(dev)
    a = torch.randn(P, M, generator=gen).to(dev)
    b = torch.randn(P, N, generator=gen).to(dev)
    kw = dict(kind="gaussian", gamma=GAMMA)
    ms = time_ms(lambda: qf.quadform(X, Y, a, b, **kw), iters=20)
    plain = time_ms(lambda: ref.quadform_ref(X, Y, a, b, **kw), iters=5)
    nbytes = 4 * P * (M * D_IN + N * D_IN + M + N + 1)
    flops = P * M * N * (2 * D_IN + 8) + P * (M + N) * 2 * D_IN
    return errs, dict(ms, dist_check=dist), plain, bound_ms(nbytes, flops)


def check_dist_check(ops, qf, dev, gen) -> dict:
    """The dynamic check's distances (``ops.rkhs_dist_sq``, m = 32
    learners against one reference model, budget 1024, d = 18): one
    launch of 2m + 1 forms, <g, g> once, bitwise the 3m-form launch
    built from ``ops.quadform`` (<g, g> m times); both timed."""
    m, M = M_KERNEL, BUDGET
    F = torch.randn(m, M, D_IN, generator=gen).to(dev)
    G = torch.randn(M, D_IN, generator=gen).to(dev)
    af = torch.randn(m, M, generator=gen).to(dev)
    ag = torch.randn(M, generator=gen).to(dev)
    af[:, M // 2:] = 0.0                  # padded slots
    kw = dict(kind="gaussian", gamma=GAMMA)
    Gm, agm = G.expand(m, M, D_IN), ag.expand(m, M)

    def three_m():
        q = ops.quadform(torch.cat([F, Gm, F]), torch.cat([F, Gm, Gm]),
                         torch.cat([af, agm, af]), torch.cat([af, agm, agm]),
                         **kw)
        return q[:m] + q[m:2 * m] - 2.0 * q[2 * m:]

    forms, launch = [], qf.quadform
    qf.quadform = lambda X, *a, **k: forms.append(X.shape[0]) or launch(
        X, *a, **k)
    try:
        got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    finally:
        qf.quadform = launch
    assert forms == [2 * m + 1], forms
    want = three_m()
    assert torch.equal(got, want), "rkhs_dist_sq differs from the 3m forms"
    new = time_ms(lambda: ops.rkhs_dist_sq(F, G, af, ag, **kw), iters=20)
    old = time_ms(three_m, iters=20)
    out = {"m": m, "forms": forms[0], "forms_3m": 3 * m, "bitwise": True,
           "ms": new["ms"], "device_ms": new["device_ms"],
           "ms_3m": old["ms"], "device_ms_3m": old["device_ms"]}
    emit({"phase": "dist_check", **out})
    return out


def _step_args(B, D, d, featurize, dev, gen):
    X = torch.randn(B, d, generator=gen).to(dev)
    y = torch.where(torch.rand(B, generator=gen) < 0.5, -1.0, 1.0).to(dev)
    w = (0.1 * torch.randn(B, D, generator=gen)).to(dev)
    b = torch.randn(B, generator=gen).to(dev)
    kw = {}
    if featurize:
        kw = dict(W=torch.randn(D, d, generator=gen).to(dev),
                  bias=(2 * np.pi * torch.rand(D, generator=gen)).to(dev),
                  scale=float(np.sqrt(2.0 / D)))
    return (X, y, w, b), kw


def check_primal_step(fused, ref, dev, gen, featurize: bool):
    if featurize:
        # the engine's shape, then every slice and cluster edge of the
        # geometry (256 features a block, 8 blocks a cluster)
        cases = [(32, 2048, D_IN), (1, 1, D_IN), (3, 127, D_IN),
                 (3, 129, D_IN), (129, 130, 7), (127, 256, D_IN),
                 (5, 2049, D_IN), (5, 4096, D_IN), (5, 4097, D_IN),
                 (3, 2048, 33)]
        main = (32, 2048)
    else:
        cases = [(1024, D_IN, D_IN), (1, 1, 1), (127, D_IN, D_IN),
                 (129, 130, 130), (130, 7, 7)]
        main = (1024, D_IN)
    errs = {}
    for loss in ("hinge", "squared"):
        for B, D, d in cases:
            args, kw = _step_args(B, D, d, featurize, dev, gen)
            got = fused.primal_step(*args, loss=loss, eta=0.5, lam=0.01, **kw)
            want = ref.primal_step_ref(*args, loss=loss, eta=0.5, lam=0.01,
                                       **kw)
            err = max(close(g, w, f"primal_step {'rff' if featurize else 'linear'}"
                            f"/{name} {loss} B={B} D={D}")
                      for g, w, name in zip(got, want, ["w", "b", "ell", "yhat"]))
            if (B, D) == main:
                errs[loss] = err
    if featurize:
        for D in (N_FEATURES, N_FEATURES + 1):
            args, kw = _step_args(max(BATCHES), D, D_IN, True, dev, gen)
            rows_independent_of_batch(
                lambda B: fused.primal_step(*(a[:B] for a in args), **kw),
                f"primal_step rff D={D}")
    B, D = main
    args, kw = _step_args(B, D, D_IN, featurize, dev, gen)
    ms = time_ms(lambda: fused.primal_step(*args, loss="hinge", **kw))
    plain = time_ms(lambda: ref.primal_step_ref(*args, loss="hinge", **kw))
    if featurize:
        nbytes = 4 * (B * D_IN + 2 * B + 2 * B * D + D * D_IN + D + 3 * B)
        flops = B * D * 2 * (2 * D_IN + 3) + B * D * 4
    else:
        nbytes = 4 * (B * D_IN + 2 * B + 2 * B * D + 3 * B)
        flops = B * D * 6
    return errs, ms, plain, bound_ms(nbytes, flops)


def rff_atol(D: int) -> float:
    return RFF_ATOL_OF_SCALE * float(np.sqrt(2.0 / D))


def off16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts 4 bytes past a 16-byte
    boundary, as a bucket sliced from a larger tensor may."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    start = (4 - flat.data_ptr() // 4 % 4) % 4 + 1
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def check_rff(rffmod, ref, dev, gen):
    """``rff`` against ``rff_ref`` to a thousandth of the output bound,
    with a control: the plain map with a bf16 projection must miss that
    limit (the check can see such a kernel).  At every bucket size of
    ``RFF_BUCKETS`` (a bucket the first M rows of a 64-row X, as
    serving slices them): within that limit, every row bitwise the
    one-row call, X 4 bytes off a 16-byte boundary bitwise X aligned,
    and timed beside the plain version (``by_bucket``); the line's own
    numbers are M = 64's, and ``main`` adds the buckets weighted by a
    serving run's ``bucket_counts`` as ``weighted_*``.  Every 64-row
    case, X as drawn or ten times it, also has each row bitwise the
    one-row call."""
    cases = [(64, N_FEATURES, D_IN, 1.0), (32, N_FEATURES, D_IN, 1.0),
             (1, N_FEATURES, D_IN, 1.0), (127, 129, 7, 1.0),
             (128, 128, D_IN, 1.0), (129, 130, D_IN, 1.0),
             (3, 130, D_IN, 1.0), (130, 127, 33, 1.0),
             (64, N_FEATURES, D_IN, 10.0)]
    errs = {}
    for M, D, d, scale in cases:
        X = (scale * torch.randn(M, d, generator=gen)).to(dev)
        W = (np.sqrt(2 * GAMMA) * torch.randn(D, d, generator=gen)).to(dev)
        b = (2 * np.pi * torch.rand(D, generator=gen)).to(dev)
        label = f"rff M={M} D={D} d={d} x{scale:g}"
        Z = rffmod.rff(X, W, b)
        want = ref.rff_ref(X, W, b)
        errs[label] = close(Z, want, label, rtol=0.0, atol=rff_atol(D))
        assert torch.equal(rffmod.rff(off16(X), W, b), Z), \
            f"{label}: X off a 16-byte boundary differs"
        if (M, D, scale) == (64, N_FEATURES, 1.0):
            proj = (X.bfloat16() @ W.bfloat16().T).float() + b
            control = float(np.sqrt(2.0 / D)) * torch.cos(proj)
            control_err = float(torch.max(torch.abs(control - want)))
            assert control_err > rff_atol(D), \
                f"the bf16 control passes the rff limit ({control_err})"
        if M == 64:
            # a row's floats do not depend on the rows around it
            for i in range(M):
                assert torch.equal(rffmod.rff(X[i:i + 1], W, b)[0], Z[i]), \
                    f"{label}: row {i} differs from the one-row call"
    D = N_FEATURES
    X = torch.randn(max(RFF_BUCKETS), D_IN, generator=gen).to(dev)
    W = (np.sqrt(2 * GAMMA) * torch.randn(D, D_IN, generator=gen)).to(dev)
    b = (2 * np.pi * torch.rand(D, generator=gen)).to(dev)
    by_bucket = {}
    for M in RFF_BUCKETS:
        Xb = X[:M]
        label = f"rff bucket M={M}"
        Z = rffmod.rff(Xb, W, b)
        errs[label] = close(Z, ref.rff_ref(Xb, W, b), label, rtol=0.0,
                            atol=rff_atol(D))
        # a row's floats do not depend on the rows around it
        for i in range(M):
            assert torch.equal(rffmod.rff(Xb[i:i + 1], W, b)[0], Z[i]), \
                f"{label}: row {i} differs from the one-row call"
        assert torch.equal(rffmod.rff(off16(Xb), W, b), Z), \
            f"{label}: X off a 16-byte boundary differs"
        kern = time_ms(lambda: rffmod.rff(Xb, W, b))
        plain = time_ms(lambda: ref.rff_ref(Xb, W, b))
        nbytes = 4 * (M * D_IN + D * D_IN + D + M * D)
        by_bucket[M] = {"ms": kern["ms"], "device_ms": kern["device_ms"],
                        "plain_ms": plain["ms"],
                        "plain_device_ms": plain["device_ms"],
                        "bound_ms": bound_ms(nbytes, 2 * M * D * D_IN)[0],
                        "grid": list(rffmod.rff_geometry(M, D).grid)}
    emit({"phase": "kernel_tolerance", "name": "rff",
          "atol_at_D2048": rff_atol(N_FEATURES), "rtol": 0.0,
          "max_abs_err_any_shape": max(errs.values()),
          "bf16_projection_control_err": control_err})
    M = max(RFF_BUCKETS)
    main = by_bucket[M]
    errs = {"main": errs[f"rff M=64 D={N_FEATURES} d={D_IN} x1"],
            "max_any_shape": max(errs.values())}
    return errs, {"ms": main["ms"], "device_ms": main["device_ms"],
                  "by_bucket": by_bucket}, \
        {"ms": main["plain_ms"], "device_ms": main["plain_device_ms"]}, \
        bound_ms(4 * (M * D_IN + D * D_IN + D + M * D), 2 * M * D * D_IN)


def check_node_shapes(fused, ops, qf, ref, rff_by_bucket, dev, gen) -> dict:
    """The asynchronous runtime's kernel shapes (one node at a time):
    ``sv_predict`` at B = 1; the dynamic check ``ops.rkhs_dist_sq`` at
    m = 1 (3 forms of 1024^2), bitwise the three one-form launches; the
    SV aggregate's epsilon, one ``quadform`` form over the 65,536 slots
    of a 32-model mix, against the plain in-place route (one 17.2 GB
    Gram); ``rff`` at M = 1 (its bucket line).  Each timed beside its
    plain version and bound.  Returns {kernel: {shape: numbers}}."""
    from repro_torch.core import rkhs
    from repro_torch.core.rkhs import KernelSpec
    from repro_torch.data.streams import susy_stream

    kw = dict(kind="gaussian", gamma=GAMMA)
    N = BUDGET
    out = {}
    # sv_predict: one row against a budget-N model
    X = torch.randn(1, D_IN, generator=gen).to(dev)
    SV = torch.randn(1, N, D_IN, generator=gen).to(dev)
    A = torch.randn(1, N, generator=gen).to(dev)
    err = close(fused.sv_predict(X, SV, A, **kw),
                ref.sv_predict_ref(X, SV, A, **kw), "sv_predict B=1")
    kern = time_ms(lambda: fused.sv_predict(X, SV, A, **kw))
    plain = time_ms(lambda: ref.sv_predict_ref(X, SV, A, **kw))
    out["sv_predict"] = {"B1_N1024": {
        "ms": kern["ms"], "device_ms": kern["device_ms"],
        "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
        "bound_ms": bound_ms(4 * (D_IN + N * D_IN + N + 1),
                             N * (4 * D_IN + 8))[0], "max_abs_err": err}}
    # the node's dynamic check: 3 forms of N^2 in one launch
    F = torch.randn(1, N, D_IN, generator=gen).to(dev)
    G = torch.randn(N, D_IN, generator=gen).to(dev)
    af = torch.randn(1, N, generator=gen).to(dev)
    ag = torch.randn(N, generator=gen).to(dev)
    af[:, N // 5:] = 0.0                  # padded slots
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}, ops.LAUNCH_COUNTS
    one = [qf.quadform(Xp[None], Yp[None], ap[None], bp[None], **kw)[0]
           for Xp, Yp, ap, bp in ((F[0], F[0], af[0], af[0]),
                                  (G, G, ag, ag), (F[0], G, af[0], ag))]
    assert torch.equal(got, (one[0] + one[1] - 2.0 * one[2])[None]), \
        "rkhs_dist_sq at m = 1 differs from three one-form launches"

    def dist_plain():
        q = ref.quadform_ref(torch.stack([F[0], G, F[0]]),
                             torch.stack([F[0], G, G]),
                             torch.stack([af[0], ag, af[0]]),
                             torch.stack([af[0], ag, ag]), **kw)
        return q[0] + q[1] - 2.0 * q[2]

    err = close(got[0], dist_plain(), "rkhs_dist_sq m=1")
    kern = time_ms(lambda: ops.rkhs_dist_sq(F, G, af, ag, **kw))
    plain = time_ms(dist_plain)
    forms = {"ms": kern["ms"], "device_ms": kern["device_ms"],
             "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
             "bound_ms": bound_ms(
                 4 * 3 * (2 * N * D_IN + 2 * N + 1),
                 3 * (N * N * (2 * D_IN + 8) + 2 * N * 2 * D_IN))[0],
             "max_abs_err": err, "bitwise_one_form_launches": True}
    # the aggregate's epsilon: one form over 2 n tau = 65,536 SUSY rows
    M = 2 * M_KERNEL * BUDGET
    Xs, _ = susy_stream(BUDGET, 2 * M_KERNEL, d=D_IN, seed=0)
    sv = torch.as_tensor(Xs.reshape(-1, D_IN), device=dev)
    beta = (torch.randn(M, generator=gen) / M_KERNEL).to(dev)
    spec = KernelSpec("gaussian", gamma=GAMMA)
    ops.reset_launch_counts()
    got = ops.quadform_spec(spec, sv[None], sv[None], beta[None],
                            beta[None])[0]
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}, ops.LAUNCH_COUNTS
    torch.cuda.empty_cache()
    err = close(got, rkhs.quadform_(rkhs.gram(spec, sv, sv), beta, beta),
                "quadform P=1 M=N=65536")
    torch.cuda.empty_cache()
    kern = time_ms(lambda: ops.quadform_spec(spec, sv[None], sv[None],
                                             beta[None], beta[None]),
                   iters=10, warmup=2)
    plain = time_ms(lambda: rkhs.quadform_(rkhs.gram(spec, sv, sv), beta,
                                           beta), iters=3, warmup=1)
    torch.cuda.empty_cache()
    out["quadform"] = {"dist_one_P3_1024sq": forms, "aggregate_P1_65536sq": {
        "ms": kern["ms"], "device_ms": kern["device_ms"],
        "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
        "bound_ms": bound_ms(4 * (2 * M * D_IN + 2 * M + 1),
                             M * M * (2 * D_IN + 8) + 2 * M * 2 * D_IN)[0],
        "max_abs_err": err, "value": float(got)}}
    b1 = rff_by_bucket[1]
    out["rff"] = {"M1_D2048": {k: b1[k] for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")}}
    emit({"phase": "node_shapes", **out})
    return out


def check_slice_shapes(fused, ops, ref, dev, gen) -> dict:
    """The kernels at the shapes the sweep and population phases give
    them: ``sv_predict`` over the SV sweep's stacked rows (B = 8 x 32);
    the grouped dynamic check (``ops.rkhs_dist_sq_groups``, 8 configs'
    2m + 1 forms of 1024^2 in one launch), each config's distances
    bitwise its own ``rkhs_dist_sq`` launch; the RFF step over B = 256
    stacked rows; the linear step over the population (B = 10^5,
    D = 4).  Each against its plain version, timed beside it with its
    bound.  Returns {kernel: {shape: numbers}}."""
    kw = dict(kind="gaussian", gamma=GAMMA)
    n, m, N = len(SV_SWEEP), M_KERNEL, BUDGET
    B = n * m
    out = {}

    def line(fn, plain, nbytes, flops, err, **extra):
        kern, pl = time_ms(fn, iters=20), time_ms(plain, iters=5)
        return {"ms": kern["ms"], "device_ms": kern["device_ms"],
                "plain_ms": pl["ms"], "plain_device_ms": pl["device_ms"],
                "bound_ms": bound_ms(nbytes, flops)[0],
                "bound_by": bound_ms(nbytes, flops)[1], "max_abs_err": err,
                **extra}

    X = torch.randn(B, D_IN, generator=gen).to(dev)
    SV = torch.randn(B, N, D_IN, generator=gen).to(dev)
    A = torch.randn(B, N, generator=gen).to(dev)
    err = close(fused.sv_predict(X, SV, A, **kw),
                ref.sv_predict_ref(X, SV, A, **kw), f"sv_predict B={B}")
    out["sv_predict"] = {f"B{B}_N{N}": line(
        lambda: fused.sv_predict(X, SV, A, **kw),
        lambda: ref.sv_predict_ref(X, SV, A, **kw),
        4 * (B * D_IN + B * N * D_IN + B * N + B), B * N * (4 * D_IN + 8),
        err)}
    del SV
    F = torch.randn(n, m, N, D_IN, generator=gen).to(dev)
    G = torch.randn(n, N, D_IN, generator=gen).to(dev)
    af = torch.randn(n, m, N, generator=gen).to(dev)
    ag = torch.randn(n, N, generator=gen).to(dev)
    af[..., N // 2:] = 0.0
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq_groups(F, G, af, ag, **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}, ops.LAUNCH_COUNTS
    for k in range(n):
        assert torch.equal(got[k], ops.rkhs_dist_sq(F[k], G[k], af[k], ag[k],
                                                    **kw)), \
            f"grouped check: config {k} differs from its own launch"

    def plain_groups():
        return torch.stack([
            ref.quadform_ref(torch.cat([F[k], G[k:k + 1], F[k]]),
                             torch.cat([F[k], G[k:k + 1],
                                        G[k].expand(m, N, D_IN)]),
                             torch.cat([af[k], ag[k:k + 1], af[k]]),
                             torch.cat([af[k], ag[k:k + 1],
                                        ag[k].expand(m, N)]), **kw)
            for k in range(n)])

    q = plain_groups()
    want = q[:, :m] + q[:, m:m + 1] - 2.0 * q[:, m + 1:]
    err = close(got, want, f"rkhs_dist_sq_groups P={GROUPED_P}")
    P = GROUPED_P
    out["quadform"] = {f"P{P}_1024sq": line(
        lambda: ops.rkhs_dist_sq_groups(F, G, af, ag, **kw), plain_groups,
        4 * P * (2 * N * D_IN + 2 * N + 1),
        P * (N * N * (2 * D_IN + 8) + 2 * N * 2 * D_IN), err,
        bitwise_own_launches=True)}
    del F, G, af, ag
    torch.cuda.empty_cache()
    for label, featurize, (B, D, d) in (
            ("primal_step_rff", True, (n * m, N_FEATURES, D_IN)),
            ("primal_step_linear", False, (POP_M, POP_D, POP_D))):
        args, kw2 = _step_args(B, D, d, featurize, dev, gen)
        got = fused.primal_step(*args, loss="hinge", eta=0.5, lam=0.01, **kw2)
        want = ref.primal_step_ref(*args, loss="hinge", eta=0.5, lam=0.01,
                                   **kw2)
        err = max(close(g, w, f"{label} B={B} D={D}")
                  for g, w in zip(got, want))
        if featurize:
            nbytes = 4 * (B * d + 2 * B + 2 * B * D + D * d + D + 3 * B)
            flops = B * D * 2 * (2 * d + 3) + B * D * 4
        else:
            nbytes = 4 * (B * d + 2 * B + 2 * B * D + 3 * B)
            flops = B * D * 6
        out[label] = {f"B{B}_D{D}": line(
            lambda: fused.primal_step(*args, loss="hinge", **kw2),
            lambda: ref.primal_step_ref(*args, loss="hinge", **kw2),
            nbytes, flops, err)}
    emit({"phase": "slice_shapes", **out})
    return out


def bucket_weighted(by_bucket: dict, counts: dict) -> dict:
    """The mean of each number of ``by_bucket`` over a serving run's
    launches: ``counts`` maps a bucket size to its launches."""
    n = sum(counts.values())
    keys = ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms")
    return {k: sum(by_bucket[int(M)][k] * c for M, c in counts.items()) / n
            for k in keys}


def one_pass_p(q, k, v, causal=True):
    """The plain attention with the weights p rounded once to bf16 before
    p.v: a one-pass bf16 product, as ``scaled_dot_product_attention``
    runs it.  The control that shows what keeping p in float32 through
    p.v buys: the float32 kernel meets 2e-5, this misses it."""
    S, L, hd = q.shape[1], k.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        hide = torch.ones(S, L, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(hide[None], -1e30)
    w = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bqk,bkd->bqd", w, v.float())


def flash_timing(flashmod, ref, BH, S, hd, batch, dev, gen):
    """``flash`` on causal bf16 (BH, S, hd) inputs drawn from ``gen``:
    its time, the plain version's, ``scaled_dot_product_attention``'s on
    the same tensors as (batch, BH / batch, S, hd), the bound, and the
    products and bytes the bound counts."""
    bf16 = torch.bfloat16
    q, k, v = (torch.randn(BH, S, hd, generator=gen).to(dev).to(bf16)
               for _ in range(3))
    ms = time_ms(lambda: flashmod.flash_attention(q, k, v), iters=20)
    plain = time_ms(lambda: ref.flash_ref(q, k, v), iters=5)
    q4, k4, v4 = (t.view(batch, BH // batch, S, hd) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True), iters=20)
    pairs = S * (S + 1) // 2                 # causal: the visible pairs
    gemm = BH * pairs * hd * 2               # q.k, and again p.v
    nbytes = 2 * 4 * BH * S * hd             # q, k, v read, O written
    # q.k: products of bf16 values are exact in fp32, so bf16 tensor
    # cores accumulating in fp32 compute it at their peak; p.v with p
    # in fp32 precision takes three bf16 passes (p split into bf16 high,
    # middle and low parts; v is exact).  The softmax (scale, max,
    # subtract, exp, sum: 5 per pair) runs beside them on the CUDA cores.
    bound = max(bound_ms(nbytes, gemm * (1 + 3), BF16_TC_FLOPS_PER_S),
                bound_ms(nbytes, BH * pairs * 5))
    return ms, plain, library, bound, gemm, nbytes


def check_flash(flashmod, ref, dev, gen):
    """``flash`` against ``ref.flash_ref`` (float32 plain): float32 within
    2e-5 (a TF32 plain version must miss that, and so must the plain
    version with p rounded once to bf16 on the main path's bf16 inputs,
    where the float32 kernel meets it); bf16 the float32 kernel's result
    rounded once, and within 2 bf16 ulps of the plain result rounded to
    bf16 (plus the float32 limit); a repeat bitwise."""
    bf16, f32 = torch.bfloat16, torch.float32
    BH, S, hd = FLASH_MAIN
    # (BH, S, hd, dtype, causal, window)
    cases = [(BH, S, hd, bf16, True, 0), (BH, 1, hd, bf16, True, 0),
             (BH, 127, hd, bf16, True, 0), (BH, 129, hd, bf16, True, 0),
             (16, 256, hd, bf16, False, 0), (16, 256, hd, bf16, True, 100),
             (16, 1500, 128, f32, True, 0), (16, 1, 128, f32, True, 0),
             (16, 127, 128, f32, True, 0), (16, 129, 64, f32, True, 0),
             (16, 256, 64, f32, False, 0), (16, 256, 64, f32, True, 100)]
    errs, ulps, beyond = {}, {}, {}
    control_err = one_pass_err = None
    for bh, s_, d, dt, causal, window in cases:
        q, k, v = (torch.randn(bh, s_, d, generator=gen).to(dev).to(dt)
                   for _ in range(3))
        kw = dict(causal=causal, window=window)
        label = f"flash {bh}x{s_}x{d} {str(dt)[6:]} causal={causal} " \
                f"window={window}"
        o = flashmod.flash_attention(q, k, v, **kw)
        want = ref.flash_ref(q.float(), k.float(), v.float(), **kw)
        if dt == f32:
            errs[label] = close_dev(o, want, label, KERNEL_TOL, KERNEL_TOL)
            if s_ == 1500:
                tf32(True)
                control = ref.flash_ref(q, k, v, **kw)
                tf32(False)
                control_err, bad = excess(control, want, KERNEL_TOL,
                                          KERNEL_TOL)
                assert bad > 0, f"the TF32 control passes ({control_err})"
        else:
            # the float32 kernel on the same (widened) values, rounded
            # once to bf16, is the bf16 kernel's output bitwise; and it
            # is within the float32 limit of the plain version
            o32 = flashmod.flash_attention(q.float(), k.float(), v.float(),
                                           **kw)
            assert torch.equal(o, o32.to(bf16)), f"{label}: bf16 output " \
                f"is not the float32 kernel's rounded once"
            close_dev(o32, want, label + " (float32 kernel)", KERNEL_TOL,
                      KERNEL_TOL)
            if (bh, s_, d) == FLASH_MAIN:
                one_pass_err, bad = excess(one_pass_p(q, k, v), want,
                                           KERNEL_TOL, KERNEL_TOL)
                assert bad > 0, f"the one-pass p control passes " \
                    f"({one_pass_err})"
            w16 = want.to(bf16).float()
            gap = (o.float() - w16).abs()
            ratio = gap / bf16_ulp(w16)
            ulps[label] = float(ratio.max())
            far = ratio > BF16_ULPS
            beyond[label] = {
                "n": int(far.sum()), "of": int(o.numel()),
                "max_abs_plain": float(w16.abs()[far].max()) if far.any()
                else 0.0,
                "max_abs_err": float(gap[far].max()) if far.any() else 0.0}
            # 2 ulps wherever a bf16 ulp is above the float32 limit: below
            # it the plain version's own float32 rounding decides the ulps
            assert bool((gap <= BF16_ULPS * bf16_ulp(w16)
                         + KERNEL_TOL).all()), (label, beyond[label])
            errs[label] = float((o.float() - want).abs().max())
        assert torch.equal(o, flashmod.flash_attention(q, k, v, **kw)), \
            f"{label}: a repeat differs"
    ms, plain, library, bound, gemm, nbytes = flash_timing(
        flashmod, ref, BH, S, hd, LM_BATCH, dev, gen)
    emit({"phase": "kernel_tolerance", "name": "flash",
          "rtol": KERNEL_TOL, "atol": KERNEL_TOL, "bf16_ulps": BF16_ULPS,
          "max_abs_err_fp32": max(v for k_, v in errs.items()
                                  if "float32" in k_),
          "max_ulps_bf16": max(ulps.values()),
          "bf16_beyond_2_ulps": beyond,
          "tf32_control_err": control_err,
          "one_pass_p_control_err": one_pass_err,
          # the same work all on the CUDA cores in fp32, as the kernel
          # does it
          "bound_ms_fp32_cores": bound_ms(nbytes, 2 * gemm)[0]})
    # where the products run and at what rate: attention's usual count
    # (q.k and p.v on the visible pairs) over the device time
    emit({"phase": "flash_route", "route": flashmod.ROUTE,
          "shape": list(FLASH_MAIN), "device_ms": ms["device_ms"],
          "attention_tflops": gemm * 2 / ms["device_ms"] / 1e9,
          "library_attention_tflops": gemm * 2 / library["device_ms"] / 1e9})
    main = next(iter(errs))
    return ({"main": errs[main], "max_fp32": max(
                v for k_, v in errs.items() if "float32" in k_)},
            dict(ms, library_ms=library["ms"],
                 library_device_ms=library["device_ms"]),
            plain, bound)


def check_gram(grammod, ref, dev, gen):
    """``gram`` against ``ref.gram_ref`` within 2e-5 across its tiles,
    stores and feature chunks (M, N in ``GRAM_SIDES``, d in ``GRAM_D``),
    a row alone bitwise its row of the whole Gram, a repeat bitwise;
    timed at the SV sync's shape (gaussian, and linear beside
    ``torch.matmul``), where ``gram_path`` holds it to the plain
    version."""
    errs = {}
    for kind in ("gaussian", "poly", "linear"):
        kw = dict(kind=kind, gamma=GAMMA)
        for d in GRAM_D:
            for M in GRAM_SIDES:
                for N in GRAM_SIDES:
                    X = torch.randn(M, d, generator=gen).to(dev)
                    Y = torch.randn(N, d, generator=gen).to(dev)
                    label = f"gram {kind} {M}x{N} d={d}"
                    K = grammod.gram(X, Y, **kw)
                    errs[label] = close_dev(K, ref.gram_ref(X, Y, **kw), label,
                                            KERNEL_TOL, KERNEL_TOL)
                    if M == 130:
                        for i in (0, 63, 64, 129):
                            assert torch.equal(
                                grammod.gram(X[i:i + 1], Y, **kw)[0], K[i]), \
                                f"{label}: row {i} alone differs"
                        assert torch.equal(grammod.gram(X, Y, **kw), K), \
                            f"{label}: a repeat differs"
    M = N = GRAM_M
    X = torch.randn(M, D_IN, generator=gen).to(dev)
    Y = torch.randn(N, D_IN, generator=gen).to(dev)
    kw = dict(kind="gaussian", gamma=GAMMA)
    ms = time_ms(lambda: grammod.gram(X, Y, **kw), iters=20)
    plain = time_ms(lambda: ref.gram_ref(X, Y, **kw), iters=10)
    lin = time_ms(lambda: grammod.gram(X, Y, kind="linear"), iters=20)
    library = time_ms(lambda: torch.matmul(X, Y.T), iters=20)
    nbytes = 4 * (M * D_IN + N * D_IN + M * N)
    flops = M * N * (2 * D_IN + 6) + (M + N) * 2 * D_IN
    emit({"phase": "kernel_tolerance", "name": "gram",
          "rtol": KERNEL_TOL, "atol": KERNEL_TOL,
          "max_abs_err_edges": max(errs.values()),
          "edges": {"sides": GRAM_SIDES, "d": GRAM_D}})
    return ({"max_edges": max(errs.values())},
            dict(ms, linear_ms=lin["ms"], linear_device_ms=lin["device_ms"],
                 linear_bound_ms=bound_ms(nbytes, M * N * 2 * D_IN)[0],
                 linear_library_ms=library["ms"],
                 linear_library_device_ms=library["device_ms"]),
            plain, bound_ms(nbytes, flops))


# ---------------------------------------------------------------------------
# Phase 3: engine.run end to end
# ---------------------------------------------------------------------------


def e2e_configs():
    from repro_torch.core.learners import LearnerConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.core.rff import RFFSpec
    from repro_torch.core.rkhs import KernelSpec

    sv = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                       budget=BUDGET, dim=D_IN,
                       kernel=KernelSpec("gaussian", gamma=GAMMA))
    rff = RFFSpec(dim=D_IN, num_features=N_FEATURES, gamma=GAMMA, seed=0)
    lin = LearnerConfig(algo="linear_sgd", loss="hinge", dim=D_IN)
    return [
        ("sv_periodic", sv, M_KERNEL, ProtocolConfig(kind="periodic", period=50),
         ("sv_predict", "quadform")),
        ("sv_dynamic", sv, M_KERNEL,
         ProtocolConfig(kind="dynamic", delta=16.0, mini_batch=10),
         ("sv_predict", "quadform")),
        ("rff_dynamic", rff, M_KERNEL,
         ProtocolConfig(kind="dynamic", delta=9.0, mini_batch=10),
         ("rff_step",)),
        ("linear_periodic", lin, M_LINEAR,
         ProtocolConfig(kind="periodic", period=50), ("linear_step",)),
    ]


def _recording(sub, dists: list, groups: list | None = None):
    """``sub`` with every distance its dynamic check computes appended
    to ``dists`` (numbers unchanged: the check already reads the
    device): the engine's stacked check, an async node's and a sweep's
    grouped check (whose number of configs goes to ``groups``)."""
    base = type(sub)

    class Recording(base):
        grouped = False

        def dist_to_ref(self, models, ref):
            d = base.dist_to_ref(self, models, ref)
            if not Recording.grouped:
                dists.append(d.cpu().numpy().copy())
            return d

        def dist_one(self, model, ref):
            d = base.dist_one(self, model, ref)
            dists.append(d.cpu().numpy().reshape(1))
            return d

        def dist_to_ref_grouped(self, models, refs):
            Recording.grouped = True
            try:
                out = base.dist_to_ref_grouped(self, models, refs)
            finally:
                Recording.grouped = False
            dists.extend(d.cpu().numpy().copy() for d in out)
            if groups is not None:
                groups.append(len(models))
            return out

    return Recording(**{f.name: getattr(sub, f.name)
                        for f in dataclasses.fields(sub)})


def _device_seconds(prof) -> collections.Counter:
    """Device seconds of every CUDA activity a profile recorded, by
    name: read from the profiler's own event records, because building
    ``prof.events()`` takes the host minutes for the millions of kernels
    of an async run's node rounds."""
    by_kernel: collections.Counter = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name()[:60]] += e.duration_ns() / 1e9
    return by_kernel


def _port_seconds(by_kernel) -> dict:
    """The device seconds of the port's own kernels (csrc/*.cu, all in
    an anonymous namespace), by kernel function name."""
    out: collections.Counter = collections.Counter()
    for name, secs in by_kernel.items():
        name = name.removeprefix("void ")
        if name.startswith("(anonymous namespace)::"):
            out[name.split("::")[1].split("(")[0].split("<")[0]] += secs
    return dict(out)


# ---------------------------------------------------------------------------
# The reference-backend runs of phases 3, 4, 7, 8 and 9, in a second process
# ---------------------------------------------------------------------------


class _ReferenceRuns:
    """One spawned process, with a CUDA context of its own, that runs
    the reference-backend run of each run of phases 3, 4, 7, 8 and 9
    while this process runs the same run's bitwise repeat: two checks of
    one run, whose seconds the script paid one after the other (the
    async phase's reference runs took 61.5 s, its repeats 94.3 s more
    on an H100 80GB HBM3 at 700 W, by ``smoke_parts.py``).  A job
    rebuilds its run's inputs from the same seeds and configs and
    returns the result with its own wall seconds and peak memory, taken
    beside the repeat
    (``reference_beside_repeat`` on the line).  Each timed run and busy
    window runs before its job is submitted.  Phase 11's serial oracle
    runs there too, beside the repeat of the one run of these phases
    with no reference run (``async_linear_periodic``).  The process
    starts before the kernel build and is closed after phase 11."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=1, mp_context=multiprocessing.get_context("spawn"),
            initializer=_reference_init, initargs=(str(ROOT / "src"),))
        self.ready = self.pool.submit(_reference_ready)
        self.early: dict = {}

    def submit(self, job, *args):
        self.ready.result()
        return self.pool.submit(job, *args)

    def start_early(self, job, *args) -> None:
        """Submit now a job whose result a later phase reads
        (``result_of``): beside a repeat that has no reference run of its
        own."""
        self.early[job.__name__, args] = self.submit(job, *args)

    def settle(self) -> None:
        """Wait for the early jobs, before the next timed run."""
        for fut in self.early.values():
            fut.exception()

    def result_of(self, job, *args):
        fut = self.early.pop((job.__name__, args), None)
        return (fut or self.submit(job, *args)).result()

    def close(self) -> None:
        self.pool.shutdown()


def _reference_init(src: str) -> None:
    sys.path.insert(0, src)
    torch.use_deterministic_algorithms(True)


def _reference_ready() -> str:
    torch.zeros(1, device="cuda")
    return torch.cuda.get_device_name(0)


def _timed_reference(fn) -> tuple:
    """(fn's value, its wall s, its peak device bytes) in this process."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    return out, secs, peak


def _reference_e2e(name: str) -> tuple:
    from repro_torch.core import engine
    from repro_torch.data.streams import susy_stream
    _, learner, m, pcfg, _ = next(c for c in e2e_configs() if c[0] == name)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    return _timed_reference(lambda: engine.run(
        learner, pcfg, X, Y, backend="reference", device="cuda"))


def _reference_serve(name: str) -> tuple:
    """The reference serving run, and its answers (``_answers``)."""
    from repro_torch.data.streams import susy_stream
    from repro_torch.serving import (KernelServingEngine, make_arrivals,
                                     serve_stream)
    _, e2e, _, arrival, kw = next(c for c in serve_configs()
                                  if c[0] == name)
    _, learner, m, pcfg, _ = next(c for c in e2e_configs() if c[0] == e2e)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    arrivals = make_arrivals(arrival, rate=SERVE_RATE, seed=0)
    with _Instrumented(KernelServingEngine) as inst:
        out = _timed_reference(lambda: serve_stream(
            learner, pcfg, X, Y, arrivals=arrivals, backend="reference",
            device="cuda", **kw))
    return out + (_answers(inst.engines[0]),)


def _reference_async(name: str) -> tuple:
    from repro_torch.data.streams import susy_stream
    from repro_torch.runtime import run_async_simulation
    _, learner, m, T, acfg, sys_cfg, _, _ = next(
        c for c in async_configs() if c[0] == name)
    X, Y = (a[:T] for a in susy_stream(T_ROUNDS, m, d=D_IN, seed=0))
    return _timed_reference(lambda: run_async_simulation(
        learner, acfg, X, Y, backend="reference", sys_cfg=sys_cfg,
        record_divergence=False, device="cuda"))


def _reference_sweep(name: str) -> tuple:
    from repro_torch.core import engine
    from repro_torch.data.streams import susy_stream
    _, learner, m, grid, _, _ = next(c for c in sweep_configs()
                                     if c[0] == name)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    return _timed_reference(lambda: engine.sweep(
        learner, grid, X, Y, backend="reference", device="cuda"))


def _reference_oracle(name: str) -> tuple:
    """Phase 11's serial oracle run ``name`` (``ORACLE_RUNS``)."""
    from repro_torch.core import simulation
    from repro_torch.data.streams import susy_stream
    e2e, T, fn = ORACLE_RUNS[name]
    _, learner, m, pcfg, _ = next(c for c in e2e_configs() if c[0] == e2e)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    return _timed_reference(lambda: getattr(simulation, fn)(
        learner, pcfg, X[:T], Y[:T], device="cuda"))


def _reference_churn(e2e: str) -> tuple:
    """``_sv_churn``'s reference run, and its rejoin downloads."""
    from repro_torch.core import substrate
    from repro_torch.data.streams import susy_stream
    from repro_torch.kernels import ops
    _, sv, m, pcfg, _ = next(c for c in e2e_configs() if c[0] == e2e)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    rejoins: list = []
    sub = _rejoin_logged(substrate.substrate_of(sv, backend="reference"),
                         rejoins)
    want, secs, _, peak = _timed_population(
        ops, {}, (), e2e, _churn_spec(m), sub, pcfg, X, Y)
    torch.cuda.empty_cache()
    return want, secs, peak, rejoins


#: phase 3's rounds per wall second, by run (the sweeps' solo rates)
RATES: dict = {}
#: a run's busy share is read over its first 1 / BUSY_WINDOW_DIV rounds
BUSY_WINDOW_DIV = 20


def run_e2e(ops, totals, runs, refs):
    from repro_torch.core import engine, substrate
    from repro_torch.data.streams import susy_stream

    for name, learner, m, pcfg, kernels in e2e_configs():
        X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = engine.run(learner, pcfg, X, Y, backend="kernels", device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{name}: {k} never launched"
            totals[k] = totals.get(k, 0) + counts[k]
        if name.startswith("sv_"):
            # the sync compresses through quadform: no (m tau)^2 Gram
            assert peak < SV_PEAK_LIMIT, f"{name}: peak memory {peak} B"
        # the device time of every CUDA kernel comes from a window; then
        # the reference run in the second process, beside the repeat,
        # which records the distances its checks compare with delta
        K = _window(T_ROUNDS)
        by_kernel, busy = _busy_window(lambda: engine.run(
            learner, pcfg, X[:K], Y[:K], backend="kernels", device="cuda"),
            K, T_ROUNDS)
        reference = refs.submit(_reference_e2e, name)
        dists: list = []
        again = engine.run(
            _recording(substrate.substrate_of(learner, backend="kernels"),
                       dists), pcfg, X, Y, device="cuda")
        want, ref_secs, ref_peak = reference.result()
        check = {}
        if pcfg.kind == "dynamic":
            d = np.concatenate(dists)
            check = {"checks": len(dists), "delta": pcfg.delta,
                     "dist_quantiles": np.quantile(
                         d, [0.0, 0.5, 0.9, 1.0]).tolist(),
                     "min_margin_to_delta": float(np.min(
                         np.abs(d - pcfg.delta)))}
        assert got.cumulative_loss.shape == (T_ROUNDS,)
        assert np.all(np.isfinite(got.cumulative_loss)), name
        assert np.array_equal(got.sync_rounds, want.sync_rounds), name
        assert got.num_syncs == want.num_syncs, name
        assert np.array_equal(got.cumulative_bytes, want.cumulative_bytes), name
        np.testing.assert_allclose(got.cumulative_loss, want.cumulative_loss,
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=name)
        if len(got.eps_history):
            np.testing.assert_allclose(got.eps_history, want.eps_history,
                                       rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                       err_msg=name)
        for field in ("cumulative_loss", "cumulative_errors",
                      "cumulative_bytes", "sync_rounds", "eps_history",
                      "divergences"):
            assert np.array_equal(getattr(got, field), getattr(again, field)), \
                f"{name}: repeated run differs in {field}"
        runs[name] = got
        RATES[name] = T_ROUNDS / secs
        emit({"phase": "e2e", "run": name, "m": m, "T": T_ROUNDS,
              "kernel_launches": counts,
              "rounds_per_s": T_ROUNDS / secs,
              "reference_rounds_per_s": T_ROUNDS / ref_secs,
              "reference_beside_repeat": True,
              "num_syncs": got.num_syncs, "total_bytes": got.total_bytes,
              "total_loss": got.total_loss,
              "reference_total_loss": want.total_loss,
              "error_rate": float(got.cumulative_errors[-1]) / (T_ROUNDS * m),
              "max_memory_allocated": peak,
              "reference_max_memory_allocated": ref_peak,
              # device busy share: kernel time of the profiled window over
              # the wall time of the same window unprofiled
              **busy, "top_kernels_s": dict(by_kernel.most_common(5)),
              "port_kernels_s": _port_seconds(by_kernel), **check})


# ---------------------------------------------------------------------------
# Phase 4: serve_stream end to end
# ---------------------------------------------------------------------------

SIM_FIELDS = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
              "sync_rounds", "eps_history", "divergences")

#: bench_serve's constants and the README's serving example
QPS_SLO = 0.3
QPS_PREDICT_COST = 0.04
SERVE_RATE = 16.0


def serve_configs():
    """(name, phase-3 run it must equal, kernels it must launch, arrival
    kind, engine keywords)."""
    from repro_torch.runtime import SystemConfig
    sys_cfg = SystemConfig(seed=0, compute_jitter=0.3, base_latency=0.05,
                           bandwidth=1e7)
    continuous = dict(policy="continuous", slots=2, slo=QPS_SLO,
                      predict_cost=QPS_PREDICT_COST, max_queue=256,
                      overload="shed", sys_cfg=sys_cfg)
    tick = dict(policy="tick", tick_interval=0.25,
                predict_cost=QPS_PREDICT_COST, sys_cfg=sys_cfg)
    return [
        ("serve_rff_dynamic", "rff_dynamic", ("rff", "rff_step"), "bursty",
         continuous),
        ("serve_sv_dynamic", "sv_dynamic", ("sv_predict", "quadform"),
         "poisson", continuous),
        ("serve_linear_periodic", "linear_periodic", ("linear_step",),
         "poisson", tick),
    ]


class _Instrumented:
    """Inside the block, ``KernelServingEngine`` keeps the engines it
    serves (for their final models), the wall seconds of ``serve()``
    and the host seconds of every predict launch (bucket build, copies,
    ``predict_batch``, the read back): clock reads, nothing else
    changes."""

    def __init__(self, cls):
        self.cls, self.engines, self.launch_s = cls, [], []
        self.serve_s = 0.0

    def __enter__(self):
        cls, engines, launch_s = self.cls, self.engines, self.launch_s
        self._serve, self._chunk = cls.serve, cls._predict_chunk
        serve, chunk = self._serve, self._chunk

        def timed_chunk(eng, reqs, bucket):
            t0 = time.perf_counter()
            out = chunk(eng, reqs, bucket)
            launch_s.append(time.perf_counter() - t0)
            return out

        def kept_serve(eng, tenant=0):
            engines.append(eng)
            t0 = time.perf_counter()
            out = serve(eng, tenant)
            torch.cuda.synchronize()
            self.serve_s += time.perf_counter() - t0
            return out

        cls._predict_chunk, cls.serve = timed_chunk, kept_serve
        return self

    def __exit__(self, *exc):
        self.cls.serve, self.cls._predict_chunk = self._serve, self._chunk


def _serving_face(res) -> dict:
    return {"latencies": res.latencies, "queue_depth": res.queue_depth,
            "sync_delays": res.sync_delays,
            "scalars": (res.bucket_counts, res.launches, res.num_shed,
                        res.num_deferred, res.ticks, res.wall_clock,
                        res.rounds)}


def _assert_same_serving_face(a, b, label: str) -> None:
    fa, fb = _serving_face(a), _serving_face(b)
    for k in ("latencies", "queue_depth", "sync_delays"):
        assert fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]), \
            f"{label}: serving face differs in {k}"
    assert fa["scalars"] == fb["scalars"], f"{label}: {fa['scalars']} != " \
        f"{fb['scalars']}"


def _assert_same_sim(a, b, label: str) -> None:
    for field in SIM_FIELDS:
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape and np.array_equal(x, y), \
            f"{label}: protocol view differs in {field}"


def check_rows(sub, models, X, gen, dev) -> float:
    """At every bucket size: ``predict_batch`` rows against
    ``predict_one`` bitwise, and against the plain stacked ``predict``
    of the reference backend (every learner on the row's input, the
    row's learner picked) within the parity pair.  Returns the largest
    difference from the plain version."""
    from repro_torch.serving.engine import DEFAULT_BUCKETS
    T, m, d = X.shape
    plain_sub = dataclasses.replace(sub, backend="reference")
    Xd = torch.as_tensor(X, device=dev)
    err = 0.0
    for bucket in DEFAULT_BUCKETS:
        lids = torch.randint(0, m, (bucket,), generator=gen).to(dev)
        Xb = Xd[torch.randint(0, T, (bucket,), generator=gen).to(dev),
                torch.randint(0, m, (bucket,), generator=gen).to(dev)]
        batched = sub.predict_batch(models, lids, Xb)
        for i in range(bucket):
            one = sub.predict_one(type(models)(*(v[lids[i]] for v in models)),
                                  Xb[i])
            assert torch.equal(batched[i], one), \
                f"bucket {bucket}: row {i} differs from predict_one"
        plain = torch.stack([plain_sub.predict(models, Xb[i].expand(m, d))[l]
                             for i, l in enumerate(lids.tolist())])
        err = max(err, close(batched, plain, f"predict_batch bucket {bucket}"))
    return err


def _answers(eng) -> tuple:
    """(uids, predictions) of tenant 0's served requests, completion
    order."""
    reqs = eng._tenants[0].served
    return (np.asarray([r.uid for r in reqs], np.int64),
            np.asarray([r.yhat for r in reqs], np.float64))


def check_rows_below_threshold(dev, gen) -> None:
    """The serving row contract where no kernel engages (SV budget 64,
    RFF D = 64 under ``backend="kernels"``): the plain expressions
    with fixed-order sums, on models trained for 60 rounds."""
    from repro_torch.core import engine, substrate
    from repro_torch.core.learners import LearnerConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.core.rff import RFFSpec
    from repro_torch.core.rkhs import KernelSpec
    from repro_torch.data.streams import susy_stream

    m, T = 8, 60
    out = {}
    for name, learner in (
            ("sv_budget64", LearnerConfig(
                algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                budget=64, dim=D_IN, kernel=KernelSpec("gaussian",
                                                       gamma=GAMMA))),
            ("rff_D64", RFFSpec(dim=D_IN, num_features=64, gamma=GAMMA,
                                seed=0))):
        sub = substrate.substrate_of(learner, backend="kernels").on(dev)
        X, Y = susy_stream(T, m, d=D_IN, seed=3)
        step = engine.make_protocol_step(sub, "periodic")
        params = engine.params_of(ProtocolConfig(kind="periodic", period=7))
        carry = engine.init_protocol_carry(sub, m, dev)
        for t in range(T):
            carry, _ = step(params, carry, (torch.as_tensor(X[t], device=dev),
                                            torch.as_tensor(Y[t], device=dev),
                                            t))
        out[name] = check_rows(sub, sub.models_of(carry[0]), X, gen, dev)
    emit({"phase": "serve_rows_below_threshold",
          "predict_batch_vs_plain_max_abs_err": out})


def run_serving(ops, totals, runs, refs) -> dict:
    """Returns each run's launches by bucket size."""
    from repro_torch.data.streams import susy_stream
    from repro_torch.serving import (KernelServingEngine, make_arrivals,
                                     serve_stream)

    learners = {name: (learner, m, pcfg)
                for name, learner, m, pcfg, _ in e2e_configs()}
    gen = torch.Generator().manual_seed(1)
    bucket_counts = {}
    for name, e2e_name, kernels, arrival, kw in serve_configs():
        learner, m, pcfg = learners[e2e_name]
        X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
        arrivals = make_arrivals(arrival, rate=SERVE_RATE, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with _Instrumented(KernelServingEngine) as inst:
            t0 = time.perf_counter()
            got = serve_stream(learner, pcfg, X, Y, arrivals=arrivals,
                               backend="kernels", device="cuda", **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{name}: {k} never launched"
            totals[k] = totals.get(k, 0) + counts[k]
        if name == "serve_rff_dynamic":
            # one featurization per bucket, nothing else featurizes
            assert counts.get("rff") == got.launches, (counts, got.launches)
        eng = inst.engines[0]
        models = eng.sub.models_of(eng._tenants[0].carry[0])
        rows_err = check_rows(eng.sub, models, X, gen, eng.device)

        # the protocol view is phase 3's engine.run, bitwise
        _assert_same_sim(got.sim, runs[e2e_name], name)
        assert got.rounds == T_ROUNDS and got.num_requests > 0
        K = _window(T_ROUNDS)
        by_kernel, busy = _busy_window(lambda: serve_stream(
            learner, pcfg, X[:K], Y[:K], arrivals=arrivals,
            backend="kernels", device="cuda", **kw), K, T_ROUNDS)

        # the reference backend's run in the second process, beside the
        # repeat
        reference = refs.submit(_reference_serve, name)
        again = serve_stream(learner, pcfg, X, Y, arrivals=arrivals,
                             backend="kernels", device="cuda", **kw)
        _assert_same_sim(got.sim, again.sim, f"{name} repeat")
        _assert_same_serving_face(got, again, f"{name} repeat")
        want, ref_secs, ref_peak, (ref_uids, ref_yhat) = reference.result()
        _assert_same_serving_face(got, want, f"{name} vs reference backend")
        # the answers: the same requests served, each prediction within
        # the parity pair of the reference backend's
        uids, yhat = _answers(eng)
        assert np.array_equal(uids, ref_uids), f"{name}: served requests"
        assert len(yhat) == got.num_requests and np.all(np.isfinite(yhat))
        np.testing.assert_allclose(yhat, ref_yhat, rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL,
                                   err_msg=f"{name}: predictions")
        assert np.array_equal(got.sim.sync_rounds, want.sim.sync_rounds)
        assert np.array_equal(got.sim.cumulative_bytes,
                              want.sim.cumulative_bytes)
        np.testing.assert_allclose(got.sim.cumulative_loss,
                                   want.sim.cumulative_loss,
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=name)

        launch_s = np.asarray(inst.launch_s)
        emit({"phase": "serve", "run": name, "m": m, "T": T_ROUNDS,
              "arrivals": arrival, "policy": got.policy,
              "kernel_launches": counts,
              "serve_stream_wall_s": secs, "serve_wall_s": inst.serve_s,
              "requests": got.num_requests, "shed": got.num_shed,
              "requests_per_wall_s": got.num_requests / secs,
              "rounds_per_wall_s": T_ROUNDS / secs,
              "predict_launches": got.launches,
              "bucket_counts": {str(k): v for k, v in
                                sorted(got.bucket_counts.items())},
              "host_ms_per_launch_mean": 1e3 * float(launch_s.mean()),
              "host_ms_per_launch_p50": 1e3 * float(np.median(launch_s)),
              "host_s_in_launches": float(launch_s.sum()),
              "reference_serve_wall_s": ref_secs,
              "reference_max_memory_allocated": ref_peak,
              "reference_beside_repeat": True,
              "num_syncs": got.num_syncs, "total_bytes": got.total_bytes,
              "total_loss": got.total_loss,
              "max_memory_allocated": peak,
              **busy, "top_kernels_s": dict(by_kernel.most_common(5)),
              "port_kernels_s": _port_seconds(by_kernel),
              "predictions_max_abs_err_vs_reference": float(
                  np.max(np.abs(yhat - ref_yhat))),
              "predict_batch_vs_plain_max_abs_err": rows_err,
              "event_clock_latency": got.latency_percentiles(),
              "event_clock_wall": got.wall_clock})
        bucket_counts[name] = dict(got.bucket_counts)
        runs[name] = got
        RATES[name] = T_ROUNDS / secs
    return bucket_counts


# ---------------------------------------------------------------------------
# Phase 7: the asynchronous runtime (run_async_simulation) at full width
# ---------------------------------------------------------------------------

#: the async runs' depths, cut from T_ROUNDS to keep the script inside its
#: time limit: every node round is one learner's round in the host's
#: event loop (SV: 16,000 node rounds in each of three runs; linear,
#: m = 1024: 51,200 in each of two)
ASYNC_T_SV = 500
ASYNC_T_LINEAR = 50
#: fields of an async run that must be equal across backends: the
#: protocol's decisions, the byte ledger and the event clock's face
ASYNC_EQUAL = ("sync_rounds", "num_syncs", "cumulative_bytes",
               "total_bytes", "link_bytes", "wall_clock",
               "barrier_wall_clock", "num_dropped", "events_processed",
               "mean_staleness", "max_staleness")


def async_configs():
    """(name, learner, m, T, async protocol, system, kernels it must
    launch, phase-3 run whose ledger (its first T rounds) it must equal,
    or None)."""
    from repro_torch.runtime import AsyncProtocolConfig, SystemConfig
    learners = {name: learner for name, learner, *_ in e2e_configs()}
    # examples/async_susy.py's "WAN + 5% message loss"
    wan = SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                       straggler_mult=4.0, straggler_prob=0.3,
                       drop_prob=0.05, base_latency=0.5, latency_jitter=0.5,
                       bandwidth=1e5)
    return [
        ("async_sv_dynamic", learners["sv_dynamic"], M_KERNEL, ASYNC_T_SV,
         AsyncProtocolConfig(kind="dynamic", delta=16.0, mini_batch=10,
                             alpha=1.0, staleness="constant"),
         SystemConfig(), ("sv_predict", "quadform"), "sv_dynamic"),
        ("async_rff_wan", learners["rff_dynamic"], M_KERNEL, T_ROUNDS,
         AsyncProtocolConfig(kind="dynamic", delta=9.0, mini_batch=10,
                             alpha=0.6, staleness="poly", stale_a=0.5,
                             agg_window=1.0),
         wan, ("rff",), None),
        ("async_linear_periodic", learners["linear_periodic"], M_LINEAR,
         ASYNC_T_LINEAR, AsyncProtocolConfig(kind="periodic", period=10),
         SystemConfig(), (), None),
    ]


def run_async(ops, totals, runs, refs) -> None:
    """``run_async_simulation`` at full width (``async_configs``), each
    run under ``backend="kernels"``, its busy share's window, then (SV,
    RFF) under ``"reference"`` on the card in the second process beside
    a repeat that must equal the first run bitwise in every field."""
    from repro_torch.core import accounting, substrate
    from repro_torch.data.streams import susy_stream
    from repro_torch.runtime import run_async_simulation

    for name, learner, m, T, acfg, sys_cfg, kernels, e2e in async_configs():
        # the first T rounds of phase 3's stream
        X, Y = (a[:T] for a in susy_stream(T_ROUNDS, m, d=D_IN, seed=0))
        kw = dict(sys_cfg=sys_cfg, record_divergence=False, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = run_async_simulation(learner, acfg, X, Y, backend="kernels",
                                   **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{name}: {k} never launched"
            totals[k] = totals.get(k, 0) + counts[k]
        assert got.cumulative_loss.shape == (T,), name
        assert np.all(np.isfinite(got.cumulative_loss)), name
        if e2e is not None:
            # the zero-latency contract: the engine's sync rounds and
            # bytes over the same rounds (a round's decision depends on
            # the rounds up to it only)
            rounds = runs[e2e].sync_rounds
            rounds = rounds[rounds < T]
            assert np.array_equal(got.sync_rounds, rounds), \
                f"{name}: sync rounds differ from {e2e}'s"
            assert got.num_syncs == len(rounds) > 0, name
            assert np.array_equal(got.cumulative_bytes,
                                  runs[e2e].cumulative_bytes[:T]), name
        if name.startswith("async_sv"):
            # the aggregate compresses through quadform: no Gram of the
            # 2 n tau slots of its mix (17.2 GB under "reference")
            assert peak < SV_PEAK_LIMIT, f"{name}: peak memory {peak} B"
        K = _window(T)
        by_kernel, busy = _busy_window(lambda: run_async_simulation(
            learner, acfg, X[:K], Y[:K], backend="kernels", **kw), K, T)
        reference = refs.submit(_reference_async, name) if kernels else None
        if reference is None:
            # this run has no reference run: the serial oracle goes beside
            # its repeat
            for oracle in ORACLE_RUNS:
                refs.start_early(_reference_oracle, oracle)
        # the repeat, its checks' distances recorded
        dists: list = []
        sub = _recording(substrate.substrate_of(
            learner, backend="kernels"), dists)
        again = run_async_simulation(sub, acfg, X, Y, **kw)
        refs.settle()
        for field in dataclasses.fields(got):
            assert np.array_equal(getattr(got, field.name),
                                  getattr(again, field.name)), \
                f"{name}: repeated run differs in {field.name}"
        line = {}
        if reference is not None:
            want, ref_secs, ref_peak = reference.result()
            line.update(reference_wall_s=ref_secs,
                        reference_max_memory_allocated=ref_peak,
                        reference_beside_repeat=True)
            for field in ASYNC_EQUAL:
                assert np.array_equal(getattr(got, field),
                                      getattr(want, field)), \
                    f"{name}: {field} differs from the reference backend"
            np.testing.assert_allclose(
                got.cumulative_loss, want.cumulative_loss, rtol=PARITY_RTOL,
                atol=PARITY_ATOL, err_msg=name)
            np.testing.assert_allclose(
                got.eps_history, want.eps_history, rtol=PARITY_RTOL,
                atol=PARITY_ATOL, err_msg=name)
            line.update(reference_total_loss=want.total_loss,
                        reference_wall_s_per_round=line[
                            "reference_wall_s"] / (T * m))
        if acfg.kind == "periodic":
            sync_bytes = accounting.sync_bytes_linear(D_IN + 1, m)
            assert got.num_syncs == T // acfg.period, name
            assert np.array_equal(got.sync_rounds, np.arange(
                acfg.period - 1, T, acfg.period, dtype=np.int64)), name
            assert got.total_bytes == got.num_syncs * sync_bytes, name
        if acfg.kind == "dynamic":
            d = np.concatenate(dists)
            line.update(checks=len(d), delta=acfg.delta,
                        dist_quantiles=np.quantile(
                            d, [0.0, 0.5, 0.9, 1.0]).tolist(),
                        min_margin_to_delta=float(np.min(np.abs(
                            d - acfg.delta))))
        emit({"phase": "async", "run": name, "m": m, "T": T,
              "kernel_launches": counts, "wall_s": secs,
              "node_rounds_per_wall_s": T * m / secs,
              "events_processed": got.events_processed,
              "num_syncs": got.num_syncs, "total_bytes": got.total_bytes,
              "total_loss": got.total_loss,
              "error_rate": float(got.cumulative_errors[-1]) / (T * m),
              "sim_wall_clock": got.wall_clock,
              "barrier_wall_clock": got.barrier_wall_clock,
              "speedup_vs_barrier": got.speedup_vs_barrier,
              "num_dropped": got.num_dropped,
              "mean_staleness": got.mean_staleness,
              "max_staleness": got.max_staleness,
              "max_memory_allocated": peak,
              **busy, "top_kernels_s": dict(by_kernel.most_common(5)),
              "port_kernels_s": _port_seconds(by_kernel), **line})


# ---------------------------------------------------------------------------
# Phase 8: engine.sweep on a stacked config axis
# ---------------------------------------------------------------------------

#: (delta, mini_batch) of the SV and RFF sweeps' dynamic grids
SV_SWEEP = [(delta, mb) for delta in (8.0, 16.0, 32.0, 64.0)
            for mb in (5, 10)]
RFF_SWEEP = [(delta, mb) for delta in (2.25, 4.5, 9.0, 18.0)
             for mb in (5, 10)]
#: the grouped dynamic check of the SV sweep on a round every config
#: checks: n (2m + 1) forms of BUDGET^2 in one launch
GROUPED_P = len(SV_SWEEP) * (2 * M_KERNEL + 1)
SIM_EQUAL = ("cumulative_loss", "cumulative_errors", "cumulative_bytes",
             "sync_rounds", "divergences", "eps_history", "num_syncs",
             "total_bytes", "total_loss")


def sweep_configs():
    """(name, learner, m, grid, kernels it must launch, anchors): each
    anchor is (row, phase-3 run it must equal bitwise, or None for a
    solo ``engine.run`` made here)."""
    from repro_torch.core.protocol import ProtocolConfig
    learners = {name: (learner, m) for name, learner, m, *_ in e2e_configs()}

    def dynamic(grid):
        return [ProtocolConfig(kind="dynamic", delta=d, mini_batch=b)
                for d, b in grid]

    lin_grid = [ProtocolConfig(kind="periodic", period=50),
                ProtocolConfig(kind="periodic", period=10),
                ProtocolConfig(kind="dynamic", delta=0.1, mini_batch=10),
                ProtocolConfig(kind="continuous")]
    return [
        ("sweep_sv_dynamic", *learners["sv_dynamic"], dynamic(SV_SWEEP),
         ("sv_predict", "quadform"),
         [(SV_SWEEP.index((16.0, 10)), "sv_dynamic"),
          (SV_SWEEP.index((64.0, 5)), None), ("most_syncs", None)]),
        ("sweep_rff_dynamic", *learners["rff_dynamic"], dynamic(RFF_SWEEP),
         ("rff_step",), [(RFF_SWEEP.index((9.0, 10)), "rff_dynamic")]),
        ("sweep_linear_mixed", *learners["linear_periodic"], lin_grid,
         ("linear_step",), [(0, "linear_periodic")]),
    ]


def _assert_same_result(a, b, label: str) -> None:
    for field in SIM_EQUAL:
        assert np.array_equal(getattr(a, field), getattr(b, field)), \
            f"{label}: {field} differs"


def run_sweeps(ops, totals, runs, refs) -> dict:
    """``engine.sweep`` at full width (``sweep_configs``) under
    ``backend="kernels"``: each anchor row bitwise its solo run, the
    busy share's window, the grid against ``backend="reference"`` on
    the card in the second process beside a repeat bitwise.  Returns the
    SV sweep's grouped check sizes."""
    from repro_torch.core import engine, substrate
    from repro_torch.data.streams import susy_stream

    groups: list = []
    for name, learner, m, grid, kernels, anchors in sweep_configs():
        X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
        n = len(grid)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = engine.sweep(learner, grid, X, Y, backend="kernels",
                           device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{name}: {k} never launched"
            totals[k] = totals.get(k, 0) + counts[k]
        # one stacked round a round: the group's round kernel launches
        # T times, not n T
        step = kernels[0]
        assert counts[step] == T_ROUNDS, (name, step, counts[step])
        if name.startswith("sweep_sv"):
            assert peak < SV_PEAK_LIMIT, f"{name}: peak memory {peak} B"
        for i in range(n):
            assert got[i].cumulative_loss.shape == (T_ROUNDS,), name
            assert np.all(np.isfinite(got[i].cumulative_loss)), (name, i)
        syncs = [got[i].num_syncs for i in range(n)]
        solo_rates = {}
        taken = {r for r, _ in anchors if r != "most_syncs"}
        for row, e2e in anchors:
            if row == "most_syncs":
                row = max((i for i in range(n) if i not in taken),
                          key=lambda i: syncs[i])
            if e2e is not None:
                want = runs[e2e]
                solo_rates[row] = RATES[e2e]
            else:
                t0 = time.perf_counter()
                want = engine.run(learner, grid[row], X, Y,
                                  backend="kernels", device="cuda")
                torch.cuda.synchronize()
                solo_rates[row] = T_ROUNDS / (time.perf_counter() - t0)
            _assert_same_result(got[row], want, f"{name}[{row}]")
        K = _window(T_ROUNDS)
        by_kernel, busy = _busy_window(lambda: engine.sweep(
            learner, grid, X[:K], Y[:K], backend="kernels", device="cuda"),
            K, T_ROUNDS)
        reference = refs.submit(_reference_sweep, name)
        # the repeat: bitwise, its grouped checks recorded
        dists: list = []
        sizes: list = []
        sub = _recording(substrate.substrate_of(learner, backend="kernels"),
                         dists, sizes)
        again = engine.sweep(sub, grid, X, Y, device="cuda")
        for i in range(n):
            _assert_same_result(got[i], again[i], f"{name}[{i}] repeat")
        want, ref_secs, ref_peak = reference.result()
        for i in range(n):
            g, w = got[i], want[i]
            assert np.array_equal(g.sync_rounds, w.sync_rounds), (name, i)
            assert np.array_equal(g.cumulative_bytes, w.cumulative_bytes), \
                (name, i)
            np.testing.assert_allclose(g.cumulative_loss, w.cumulative_loss,
                                       rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                       err_msg=f"{name}[{i}]")
            np.testing.assert_allclose(g.eps_history, w.eps_history,
                                       rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                       err_msg=f"{name}[{i}]")
        if name.startswith("sweep_sv"):
            groups = sizes
            assert max(sizes) == n, sizes        # every config due at once
        runs[name] = got
        RATES[name] = n * T_ROUNDS / secs
        emit({"phase": "sweep", "run": name, "n_configs": n, "m": m,
              "T": T_ROUNDS, "kernel_launches": counts, "wall_s": secs,
              "config_rounds_per_s": n * T_ROUNDS / secs,
              "solo_rounds_per_s": {str(k): v for k, v in
                                    solo_rates.items()},
              "reference_wall_s": ref_secs,
              "reference_config_rounds_per_s": n * T_ROUNDS / ref_secs,
              "reference_beside_repeat": True,
              "num_syncs": syncs,
              "total_bytes": [got[i].total_bytes for i in range(n)],
              "anchors_bitwise": sorted(solo_rates),
              "grouped_checks": dict(collections.Counter(sizes)),
              "max_memory_allocated": peak,
              "reference_max_memory_allocated": ref_peak,
              **busy, "top_kernels_s": dict(by_kernel.most_common(5)),
              "port_kernels_s": _port_seconds(by_kernel)})
        torch.cuda.empty_cache()
    return {"grouped_checks": dict(collections.Counter(groups))}


# ---------------------------------------------------------------------------
# Phase 9: population/ (the participation mask)
# ---------------------------------------------------------------------------

#: benchmarks/bench_population.py's population and stream
POP_M = 100_000
POP_T = 40
POP_D = 4
POP_RATES = (0.1, 0.5, 1.0)
POP_M_BIG = 1_000_000
POP_T_BIG = 6


def _oracle_cumulative_bytes(res, mask, num_params: int) -> np.ndarray:
    """bench_population.py:59-72: every rejoiner downloads |theta| B,
    every sync moves 2 c_t |theta| B over the coordinator links."""
    from repro_torch.population import rejoin_counts
    sync_set = {int(t) for t in res.sync_rounds}
    r = rejoin_counts(mask)
    c = mask.sum(axis=1).astype(np.int64)
    per = np.zeros(mask.shape[0], np.int64)
    for t in range(mask.shape[0]):
        per[t] = int(r[t]) * num_params * 4
        if t in sync_set:
            per[t] += 2 * int(c[t]) * num_params * 4
    return np.cumsum(per)


def _timed_population(ops, totals, kernels, label, *args, **kw):
    """One ``run_population`` on the card -> (result, wall s, launches,
    peak bytes); its kernels must launch."""
    from repro_torch.population import run_population
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pres = run_population(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(ops.LAUNCH_COUNTS)
    for k in kernels:
        assert counts.get(k, 0) > 0, f"{label}: {k} never launched"
        totals[k] = totals.get(k, 0) + counts[k]
    assert np.all(np.isfinite(pres.sim.cumulative_loss)), label
    return pres, secs, counts, torch.cuda.max_memory_allocated()


def _busy_window(run, rounds: int, of: int) -> tuple:
    """The card's busy share over a bounded window, the first ``rounds``
    of a run's ``of`` rounds: ``run()`` runs that prefix once unprofiled
    for its wall time and once profiled for the device time of its CUDA
    activities.  A phase's bitwise repeat runs unprofiled; profiling it
    whole cost the async phase 226 of its 365 s on an H100 80GB HBM3 at
    700 W (``smoke_parts.py``).
    Returns (device s by kernel name, the line's ``device_s``,
    ``device_busy_share`` and ``busy_window`` fields)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel = _device_seconds(prof)
    device_s = sum(by_kernel.values())
    return by_kernel, {"device_s": device_s,
                       "device_busy_share": device_s / wall,
                       "busy_window": {"rounds": rounds, "of": of,
                                       "wall_s": wall}}


def _window(T: int) -> int:
    """Rounds of a run's busy window: its first twentieth."""
    return max(1, T // BUSY_WINDOW_DIV)


def _population_line(name, pres, secs, counts, peak, **extra) -> None:
    T, m = pres.participation.shape
    emit({"phase": "population", "run": name, "m_total": m, "T": T,
          "wall_s": secs, "rounds_per_s": T / secs,
          "learner_rounds_per_s": T * m / secs,
          "mean_cohort": pres.mean_cohort,
          "rejoins": pres.total_rejoins, "num_syncs": pres.sim.num_syncs,
          "total_bytes": pres.sim.total_bytes,
          "total_loss": pres.sim.total_loss, "kernel_launches": counts,
          "max_memory_allocated": peak, **extra})


def run_population_phase(ops, totals, runs, refs) -> None:
    """The population layer at bench_population.py's scale and the SV
    learners of phase 3 under churn (see the module docstring)."""
    from repro_torch.core import engine, substrate
    from repro_torch.core.learners import LearnerConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data.streams import separable_stream
    from repro_torch.population import ALWAYS_ON, PopulationSpec
    from repro_torch.telemetry.monitor import monitor_population

    lin = substrate.substrate_of(
        LearnerConfig(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001,
                      dim=POP_D), backend="kernels")
    num_params = lin.num_params
    X, Y = separable_stream(T=POP_T, m=POP_M, d=POP_D, seed=0, margin=0.5)
    pcfg = ProtocolConfig(kind="periodic", period=3)
    step = ("linear_step",)
    totals_by_rate = {}
    for rate in POP_RATES:
        spec = PopulationSpec(m_total=POP_M, classes=((ALWAYS_ON, 1.0),),
                              sample_rate=rate, seed=7)
        label = f"population_linear_rates@{rate}"
        pres, secs, counts, peak = _timed_population(
            ops, totals, step, label, spec, lin, pcfg, X, Y)
        want = _oracle_cumulative_bytes(pres.sim, pres.participation,
                                        num_params)
        assert np.array_equal(pres.sim.cumulative_bytes, want), label
        mon = monitor_population(pres, lin)
        assert np.array_equal(mon.series().cumulative_bytes,
                              pres.sim.cumulative_bytes), label
        assert mon.series().cumulative_bytes.dtype == np.int64, label
        totals_by_rate[rate] = pres.sim.total_bytes
        extra = {"sample_rate": rate, "bytes_equal_oracle": True,
                 "monitor_ok": mon.ok}
        if rate == 0.5:
            runs[label] = pres
            RATES[label] = POP_T / secs
            again = _timed_population(ops, {}, step, label, spec, lin, pcfg,
                                      X, Y)[0]
            _assert_same_result(pres.sim, again.sim, f"{label} repeat")
            K = _window(POP_T)
            by_kernel, busy = _busy_window(lambda: _timed_population(
                ops, {}, step, label, spec, lin, pcfg, X[:K], Y[:K]), K,
                POP_T)
            extra.update(busy, top_kernels_s=dict(by_kernel.most_common(5)))
        if rate == 1.0:
            # the whole population every round: engine.run's result
            _assert_same_result(pres.sim, engine.run(
                lin, pcfg, X, Y, device="cuda"), label)
            extra["full_participation_identical"] = True
        _population_line(label, pres, secs, counts, peak, **extra)
    assert totals_by_rate[0.1] < totals_by_rate[0.5] < totals_by_rate[1.0], \
        totals_by_rate

    # the default class mix: phones drop and recover, rejoins are charged
    spec = PopulationSpec(m_total=POP_M, sample_rate=0.8, seed=3)
    label = "population_linear_churn"
    pres, secs, counts, peak = _timed_population(
        ops, totals, step, label, spec, lin,
        ProtocolConfig(kind="dynamic", delta=200.0), X, Y)
    assert pres.total_rejoins > 0, label
    assert np.array_equal(pres.sim.cumulative_bytes, _oracle_cumulative_bytes(
        pres.sim, pres.participation, num_params)), label
    _population_line(label, pres, secs, counts, peak,
                     bytes_equal_oracle=True)
    del X, Y

    # bench_population.py's upper end: 10^6 learners
    Xb, Yb = separable_stream(T=POP_T_BIG, m=POP_M_BIG, d=POP_D, seed=0,
                              margin=0.5)
    spec = PopulationSpec(m_total=POP_M_BIG, classes=((ALWAYS_ON, 1.0),),
                          sample_rate=0.2, seed=7)
    label = "population_linear_1m"
    pres, secs, counts, peak = _timed_population(
        ops, totals, step, label, spec, lin,
        ProtocolConfig(kind="periodic", period=2), Xb, Yb)
    assert np.array_equal(pres.sim.cumulative_bytes, _oracle_cumulative_bytes(
        pres.sim, pres.participation, num_params)), label
    assert pres.sim.num_syncs == POP_T_BIG // 2, label
    _population_line(label, pres, secs, counts, peak,
                     bytes_equal_oracle=True)
    del Xb, Yb
    torch.cuda.empty_cache()

    # phase 3's SV learners under churn, against the reference backend:
    # sv_dynamic's protocol and sv_periodic's, whose syncs always find a
    # cohort
    for e2e in ("sv_dynamic", "sv_periodic"):
        _sv_churn(ops, totals, runs, refs, e2e)


def _churn_spec(m: int):
    from repro_torch.population import PopulationSpec
    return PopulationSpec(m_total=m, sample_rate=0.8, seed=3)


def _rejoin_logged(sub, log: list):
    """``sub`` with every rejoin download's bytes appended to ``log``."""
    base = type(sub)

    class Logged(base):
        def rejoin_payload_bytes(self, models, ref, rejoin):
            b = base.rejoin_payload_bytes(self, models, ref, rejoin)
            log.append(int(b))
            return b

    return Logged(**{f.name: getattr(sub, f.name)
                     for f in dataclasses.fields(sub)})


def _sv_churn(ops, totals, runs, refs, e2e: str) -> None:
    """``run_population`` of phase 3's ``e2e`` run under churn
    (``PopulationSpec(m_total=32, sample_rate=0.8, seed=3)``): kernels,
    the busy share's window, the reference backend in the second process
    beside a repeat, an all-True mask against phase 3's run."""
    from repro_torch.core import substrate
    from repro_torch.data.streams import susy_stream

    _, sv, m, pcfg, _ = next(c for c in e2e_configs() if c[0] == e2e)
    X, Y = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
    spec = _churn_spec(m)
    label = f"population_{e2e.replace('sv_', 'sv_churn_')}"
    kern = substrate.substrate_of(sv, backend="kernels")
    pres, secs, counts, peak = _timed_population(
        ops, totals, ("sv_predict", "quadform"), label, spec, kern, pcfg, X,
        Y)
    assert peak < SV_PEAK_LIMIT, f"{label}: peak memory {peak} B"
    assert pres.total_rejoins > 0, label
    if pcfg.kind == "periodic":
        assert pres.sim.num_syncs > 0, label
    K = _window(T_ROUNDS)
    by_kernel, busy = _busy_window(lambda: _timed_population(
        ops, {}, (), label, spec, kern, pcfg, X[:K], Y[:K]), K, T_ROUNDS)
    reference = refs.submit(_reference_churn, e2e)
    kern_rejoins: list = []
    again = _timed_population(ops, {}, (), label, spec,
                              _rejoin_logged(kern, kern_rejoins), pcfg, X,
                              Y)[0]
    _assert_same_result(pres.sim, again.sim, f"{label} repeat")
    want, ref_secs, ref_peak, ref_rejoins = reference.result()
    assert np.array_equal(pres.sim.sync_rounds, want.sim.sync_rounds), label
    assert np.array_equal(pres.sim.cumulative_bytes,
                          want.sim.cumulative_bytes), label
    assert kern_rejoins == ref_rejoins and len(ref_rejoins) > 0, label
    np.testing.assert_allclose(pres.sim.cumulative_loss,
                               want.sim.cumulative_loss, rtol=PARITY_RTOL,
                               atol=PARITY_ATOL, err_msg=label)
    np.testing.assert_allclose(pres.sim.eps_history, want.sim.eps_history,
                               rtol=PARITY_RTOL, atol=PARITY_ATOL,
                               err_msg=label)
    # an all-True override is phase 3's unmasked run, bitwise
    full, _, _, _ = _timed_population(
        ops, {}, (), label, spec, kern, pcfg, X, Y,
        participation=np.ones((T_ROUNDS, m), bool))
    _assert_same_result(full.sim, runs[e2e], f"{label} all-True")
    _population_line(label, pres, secs, counts, peak,
                     rejoin_bytes=sum(kern_rejoins),
                     reference_wall_s=ref_secs,
                     reference_total_loss=want.sim.total_loss,
                     reference_max_memory_allocated=ref_peak,
                     reference_beside_repeat=True,
                     all_true_equals=e2e, **busy,
                     top_kernels_s=dict(by_kernel.most_common(5)),
                     port_kernels_s=_port_seconds(by_kernel))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 10: the mesh engine (launch.mesh, run / sweep / run_population /
# the serving engine with mesh=)
# ---------------------------------------------------------------------------

#: shards of the mesh runs, all on the one card unless said otherwise
MESH_SHARDS = 4
#: (run, phase-3 run it must equal bitwise, shards)
MESH_RUNS = (("mesh_sv_dynamic", "sv_dynamic", 2),
             ("mesh_sv_dynamic", "sv_dynamic", MESH_SHARDS),
             ("mesh_sv_periodic", "sv_periodic", MESH_SHARDS),
             ("mesh_rff_dynamic", "rff_dynamic", MESH_SHARDS),
             ("mesh_linear_periodic", "linear_periodic", MESH_SHARDS))


def _one_card_mesh(n: int):
    from repro_torch.launch.mesh import make_learner_mesh
    return make_learner_mesh(devices=["cuda:0"] * n)


def check_mesh_shapes(fused, ops, ref, dev, gen) -> dict:
    """The kernels at a shard's shapes (phase 3's learners over
    ``MESH_SHARDS`` shards): ``sv_predict`` at B = M_KERNEL / 4; a
    shard's dynamic check (``ops.rkhs_dist_sq``, 2 (m/4) + 1 forms of
    1024^2 in one launch) and ``ops.rkhs_dist_sq_each`` (3 (m/4) forms,
    bitwise the check on an equal stack); the RFF step at B = M_KERNEL
    / 4; the linear step at B = M_LINEAR / 4.  Each against its plain
    version, timed beside it with its bound.  Returns {kernel: {shape:
    numbers}}."""
    kw = dict(kind="gaussian", gamma=GAMMA)
    m, N = M_KERNEL // MESH_SHARDS, BUDGET
    out = {}

    def line(fn, plain, nbytes, flops, err, **extra):
        kern, pl = time_ms(fn, iters=20), time_ms(plain, iters=5)
        return {"ms": kern["ms"], "device_ms": kern["device_ms"],
                "plain_ms": pl["ms"], "plain_device_ms": pl["device_ms"],
                "bound_ms": bound_ms(nbytes, flops)[0],
                "bound_by": bound_ms(nbytes, flops)[1], "max_abs_err": err,
                **extra}

    X = torch.randn(m, D_IN, generator=gen).to(dev)
    SV = torch.randn(m, N, D_IN, generator=gen).to(dev)
    A = torch.randn(m, N, generator=gen).to(dev)
    err = close(fused.sv_predict(X, SV, A, **kw),
                ref.sv_predict_ref(X, SV, A, **kw), f"sv_predict B={m}")
    out["sv_predict"] = {f"B{m}_N{N}": line(
        lambda: fused.sv_predict(X, SV, A, **kw),
        lambda: ref.sv_predict_ref(X, SV, A, **kw),
        4 * (m * D_IN + m * N * D_IN + m * N + m), m * N * (4 * D_IN + 8),
        err)}
    F = torch.randn(m, N, D_IN, generator=gen).to(dev)
    G = torch.randn(N, D_IN, generator=gen).to(dev)
    af = torch.randn(m, N, generator=gen).to(dev)
    ag = torch.randn(N, generator=gen).to(dev)
    af[:, N // 2:] = 0.0
    ops.reset_launch_counts()
    got = ops.rkhs_dist_sq(F, G, af, ag, **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}, ops.LAUNCH_COUNTS

    def plain_check():
        q = ref.quadform_ref(torch.cat([F, G[None], F]),
                             torch.cat([F, G[None], G.expand(m, N, D_IN)]),
                             torch.cat([af, ag[None], af]),
                             torch.cat([af, ag[None], ag.expand(m, N)]), **kw)
        return q[:m] + q[m:m + 1] - 2.0 * q[m + 1:]

    err = close(got, plain_check(), f"rkhs_dist_sq m={m}")
    P = 2 * m + 1
    check = line(lambda: ops.rkhs_dist_sq(F, G, af, ag, **kw), plain_check,
                 4 * P * (2 * N * D_IN + 2 * N + 1),
                 P * (N * N * (2 * D_IN + 8) + 2 * N * 2 * D_IN), err)
    # per-learner references, one launch of 3 m forms; on an equal
    # stack bitwise the check's distances
    Gs = G.expand(m, N, D_IN).contiguous()
    ags = ag.expand(m, N).contiguous()
    ops.reset_launch_counts()
    each = ops.rkhs_dist_sq_each(F, Gs, af, ags, **kw)
    assert dict(ops.LAUNCH_COUNTS) == {"quadform": 1}, ops.LAUNCH_COUNTS
    assert torch.equal(each, got), "rkhs_dist_sq_each != rkhs_dist_sq"

    def plain_each():
        q = ref.quadform_ref(torch.cat([F, Gs, F]), torch.cat([F, Gs, Gs]),
                             torch.cat([af, ags, af]),
                             torch.cat([af, ags, ags]), **kw)
        return q[:m] + q[m:2 * m] - 2.0 * q[2 * m:]

    err = close(each, plain_each(), f"rkhs_dist_sq_each m={m}")
    P = 3 * m
    out["quadform"] = {f"check_P{2 * m + 1}_1024sq": check,
                       f"each_P{P}_1024sq": line(
        lambda: ops.rkhs_dist_sq_each(F, Gs, af, ags, **kw), plain_each,
        4 * P * (2 * N * D_IN + 2 * N + 1),
        P * (N * N * (2 * D_IN + 8) + 2 * N * 2 * D_IN), err,
        bitwise_dist_to_ref=True)}
    del F, G, Gs, SV
    torch.cuda.empty_cache()
    for label, featurize, (B, D, d) in (
            ("primal_step_rff", True, (m, N_FEATURES, D_IN)),
            ("primal_step_linear", False,
             (M_LINEAR // MESH_SHARDS, D_IN, D_IN))):
        args, kw2 = _step_args(B, D, d, featurize, dev, gen)
        got = fused.primal_step(*args, loss="hinge", eta=0.5, lam=0.01, **kw2)
        want = ref.primal_step_ref(*args, loss="hinge", eta=0.5, lam=0.01,
                                   **kw2)
        err = max(close(g, w, f"{label} B={B} D={D}")
                  for g, w in zip(got, want))
        if featurize:
            nbytes = 4 * (B * d + 2 * B + 2 * B * D + D * d + D + 3 * B)
            flops = B * D * 2 * (2 * d + 3) + B * D * 4
        else:
            nbytes = 4 * (B * d + 2 * B + 2 * B * D + 3 * B)
            flops = B * D * 6
        out[label] = {f"B{B}_D{D}": line(
            lambda: fused.primal_step(*args, loss="hinge", **kw2),
            lambda: ref.primal_step_ref(*args, loss="hinge", **kw2),
            nbytes, flops, err)}
    emit({"phase": "mesh_shapes", "shards": MESH_SHARDS, **out})
    return out


def _mesh_line(name, shards, got, secs, counts, peak, single_rate, **extra):
    T = len(got.cumulative_loss)
    emit({"phase": "mesh", "run": name, "shards": shards, "T": T,
          "kernel_launches": counts,
          "launches_per_shard": {k: v / shards for k, v in counts.items()},
          "rounds_per_s": T / secs, "single_device_rounds_per_s": single_rate,
          "num_syncs": got.num_syncs, "total_bytes": got.total_bytes,
          "total_loss": got.total_loss, "max_memory_allocated": peak,
          **extra})


def run_mesh_phase(ops, totals, runs) -> None:
    """``engine.run`` / ``engine.sweep`` / ``run_population`` /
    ``serve_stream`` with ``mesh=`` at full width (phase 3's learners),
    each bitwise its single-device run (see the module docstring)."""
    from repro_torch.core import engine, substrate
    from repro_torch.data.streams import separable_stream, susy_stream
    from repro_torch.launch.mesh import make_learner_mesh
    from repro_torch.serving import (KernelServingEngine, make_arrivals,
                                     serve_stream)

    configs = {name: (learner, m, pcfg, kernels)
               for name, learner, m, pcfg, kernels in e2e_configs()}
    streams = {}

    def timed(label, kernels, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ops.LAUNCH_COUNTS)
        for k in kernels:
            assert counts.get(k, 0) > 0, f"{label}: {k} never launched"
            totals[k] = totals.get(k, 0) + counts[k]
        return out, secs, counts, torch.cuda.max_memory_allocated()

    for name, e2e, shards in MESH_RUNS:
        learner, m, pcfg, kernels = configs[e2e]
        if m not in streams:
            streams[m] = susy_stream(T_ROUNDS, m, d=D_IN, seed=0)
        X, Y = streams[m]
        mesh = _one_card_mesh(shards)
        got, secs, counts, peak = timed(
            name, kernels, lambda: engine.run(learner, pcfg, X, Y,
                                              backend="kernels", mesh=mesh))
        _assert_same_result(got, runs[e2e], f"{name} x{shards}")
        if e2e.startswith("sv_"):
            assert peak < SV_PEAK_LIMIT, f"{name}: peak memory {peak} B"
        extra = {"bitwise_single_device": True}
        if name == "mesh_sv_dynamic" and shards == MESH_SHARDS:
            # a repeat, bitwise; the card's busy share over a window
            again = engine.run(learner, pcfg, X, Y, backend="kernels",
                               mesh=mesh)
            _assert_same_result(again, got, f"{name} repeat")
            K = _window(T_ROUNDS)
            by_kernel, busy = _busy_window(lambda: engine.run(
                learner, pcfg, X[:K], Y[:K], backend="kernels", mesh=mesh),
                K, T_ROUNDS)
            extra.update(busy, top_kernels_s=dict(by_kernel.most_common(5)),
                         port_kernels_s=_port_seconds(by_kernel))
            # the ring topology: the same syncs, each at the ring bytes
            ring, ring_secs, _, _ = timed(
                f"{name} allreduce", kernels, lambda: engine.run(
                    learner, pcfg, X, Y, backend="kernels", mesh=mesh,
                    topology="allreduce"))
            assert np.array_equal(ring.sync_rounds, got.sync_rounds), name
            cost = engine.allreduce_cost(substrate.substrate_of(learner), m)
            per = np.zeros(T_ROUNDS, np.int64)
            per[ring.sync_rounds] = cost
            assert np.array_equal(ring.cumulative_bytes, np.cumsum(per)), name
            extra.update(allreduce_total_bytes=ring.total_bytes,
                         allreduce_bytes_per_sync=cost,
                         allreduce_rounds_per_s=T_ROUNDS / ring_secs)
        _mesh_line(name, shards, got, secs, counts, peak, RATES[e2e], **extra)
        torch.cuda.empty_cache()

    if torch.cuda.device_count() > 1:
        # one shard a card (unverified on a one-card machine)
        learner, m, pcfg, kernels = configs["sv_dynamic"]
        X, Y = streams[m]
        cards = make_learner_mesh()
        got, secs, counts, peak = timed(
            "mesh_sv_dynamic cards", kernels, lambda: engine.run(
                learner, pcfg, X, Y, backend="kernels", mesh=cards))
        _assert_same_result(got, runs["sv_dynamic"], "mesh_sv_dynamic cards")
        _mesh_line("mesh_sv_dynamic_cards", cards.size, got, secs, counts,
                   peak, RATES["sv_dynamic"], bitwise_single_device=True)

    # the RFF sweep's grid on the mesh: each row bitwise the sweep's row
    name, learner, m, grid, kernels, _ = next(
        c for c in sweep_configs() if c[0] == "sweep_rff_dynamic")
    X, Y = streams[m]
    mesh = _one_card_mesh(MESH_SHARDS)
    got, secs, counts, peak = timed(
        "mesh_sweep_rff_dynamic", kernels, lambda: engine.sweep(
            learner, grid, X, Y, backend="kernels", mesh=mesh))
    assert counts[kernels[0]] == T_ROUNDS * MESH_SHARDS, counts
    for i in range(len(grid)):
        _assert_same_result(got[i], runs[name][i], f"mesh_{name}[{i}]")
    emit({"phase": "mesh", "run": "mesh_" + name, "shards": MESH_SHARDS,
          "n_configs": len(grid), "T": T_ROUNDS, "kernel_launches": counts,
          "config_rounds_per_s": len(grid) * T_ROUNDS / secs,
          "single_device_config_rounds_per_s": RATES[name],
          "num_syncs": [got[i].num_syncs for i in range(len(grid))],
          "max_memory_allocated": peak, "bitwise_single_device": True})

    # the population at sample rate 0.5, 25,000 learners a shard
    from repro_torch.core.learners import LearnerConfig
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.population import ALWAYS_ON, PopulationSpec
    lin = substrate.substrate_of(
        LearnerConfig(algo="linear_sgd", loss="hinge", eta=0.1, lam=0.001,
                      dim=POP_D), backend="kernels")
    Xp, Yp = separable_stream(T=POP_T, m=POP_M, d=POP_D, seed=0, margin=0.5)
    spec = PopulationSpec(m_total=POP_M, classes=((ALWAYS_ON, 1.0),),
                          sample_rate=0.5, seed=7)
    label = "mesh_population_rates@0.5"
    pres, secs, counts, peak = _timed_population(
        ops, totals, ("linear_step",), label, spec, lin,
        ProtocolConfig(kind="periodic", period=3), Xp, Yp, mesh=mesh)
    _assert_same_result(pres.sim, runs["population_linear_rates@0.5"].sim,
                        label)
    assert np.array_equal(pres.sim.cumulative_bytes, _oracle_cumulative_bytes(
        pres.sim, pres.participation, lin.num_params)), label
    _population_line(label, pres, secs, counts, peak, shards=MESH_SHARDS,
                     bitwise_single_device=True, bytes_equal_oracle=True,
                     single_device_rounds_per_s=RATES[
                         "population_linear_rates@0.5"])
    del Xp, Yp

    # serve_rff_dynamic on the mesh: 2 slots a shard
    name, e2e, kernels, arrival, kw = next(
        c for c in serve_configs() if c[0] == "serve_rff_dynamic")
    learner, m, pcfg, _ = configs[e2e]
    X, Y = streams[m]
    with _Instrumented(KernelServingEngine) as inst:
        got, secs, counts, peak = timed(
            "mesh_serve_rff_dynamic", kernels, lambda: serve_stream(
                learner, pcfg, X, Y,
                arrivals=make_arrivals(arrival, rate=SERVE_RATE, seed=0),
                backend="kernels", mesh=mesh, **kw))
    _assert_same_sim(got.sim, runs[name].sim, "mesh_serve_rff_dynamic")
    assert len(inst.engines[0].scheduler.pools) == MESH_SHARDS
    eng = inst.engines[0]
    ten = eng._tenants[0]
    rows_err = 0.0
    gen = torch.Generator().manual_seed(2)
    placed = eng._models_for_predict(ten)
    r = m // MESH_SHARDS
    for k in range(MESH_SHARDS):
        rows_err = max(rows_err, check_rows(
            ten.shard_subs[k], placed[k], X[:, k * r:(k + 1) * r], gen,
            eng.devices[k]))
    emit({"phase": "mesh", "run": "mesh_serve_rff_dynamic",
          "shards": MESH_SHARDS, "slots_per_shard": got.slots,
          "kernel_launches": counts, "requests": got.num_requests,
          "requests_per_wall_s": got.num_requests / secs,
          "rounds_per_wall_s": T_ROUNDS / secs,
          "single_device_rounds_per_wall_s": RATES[name],
          "predict_launches": got.launches,
          "bucket_counts": {str(k): v for k, v in
                            sorted(got.bucket_counts.items())},
          "host_ms_per_launch_mean": 1e3 * float(np.mean(inst.launch_s)),
          "host_s_in_launches": float(np.sum(inst.launch_s)),
          "serve_wall_s": inst.serve_s,
          "max_memory_allocated": peak, "sim_bitwise_unmeshed": True,
          "rows_bitwise_predict_one": True,
          "predict_batch_vs_plain_max_abs_err": rows_err,
          "event_clock_latency": got.latency_percentiles()})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 11: the serial loop oracle
# ---------------------------------------------------------------------------

#: the SV oracle's depth: every round of it records the divergence over
#: the whole union (a (m tau)^2 form and an m tau x tau Gram a learner),
#: the dearest rounds of the script
ORACLE_T_SV = T_ROUNDS


#: phase 11's runs: (phase 3 run, depth, ``core.simulation`` function)
ORACLE_RUNS = {
    "oracle_sv_dynamic": ("sv_dynamic", ORACLE_T_SV, "run_kernel_simulation"),
    "oracle_linear_periodic": ("linear_periodic", T_ROUNDS,
                               "run_linear_simulation")}


def run_oracle_phase(runs, refs) -> None:
    """``simulation.run_kernel_simulation`` at ``sv_dynamic``'s config
    (depth ``ORACLE_T_SV``) and ``run_linear_simulation`` at
    ``linear_periodic``'s, on the card in the second process (run beside
    phase 7's ``async_linear_periodic`` repeat; ``run_beside_repeat`` on
    the line): sync rounds and bytes equal to phase 3's
    ``engine.run(backend="kernels")``, losses and compression errors
    within the parity pair, error counts equal."""
    for name, (e2e, T, _) in ORACLE_RUNS.items():
        m = next(c[2] for c in e2e_configs() if c[0] == e2e)
        got, secs, peak = refs.result_of(_reference_oracle, name)
        want = runs[e2e]
        # the engine's first T rounds (a round never reads a later one)
        w_sync = want.sync_rounds[want.sync_rounds < T]
        assert np.array_equal(got.sync_rounds, w_sync), name
        assert got.num_syncs == len(w_sync), name
        assert np.array_equal(got.cumulative_bytes,
                              want.cumulative_bytes[:T]), name
        assert np.all(np.isfinite(got.cumulative_loss)), name
        np.testing.assert_allclose(got.cumulative_loss,
                                   want.cumulative_loss[:T],
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(got.eps_history,
                                   want.eps_history[:len(w_sync)],
                                   rtol=PARITY_RTOL, atol=PARITY_ATOL,
                                   err_msg=name)
        errs_equal = bool(np.array_equal(got.cumulative_errors,
                                         want.cumulative_errors[:T]))
        emit({"phase": "oracle", "run": name, "m": m, "T": T,
              "rounds_per_s": T / secs,
              "engine_rounds_per_s": RATES[e2e],
              "num_syncs": got.num_syncs, "total_bytes": got.total_bytes,
              "total_loss": got.total_loss,
              "engine_total_loss": float(want.cumulative_loss[T - 1]),
              "loss_max_abs_diff": float(np.max(np.abs(
                  got.cumulative_loss - want.cumulative_loss[:T]))),
              "eps_max_abs_diff": float(np.max(np.abs(
                  got.eps_history - want.eps_history[:len(w_sync)]),
                  initial=0.0)),
              "errors_equal": errs_equal,
              "max_memory_allocated": peak, "run_beside_repeat": True})


# ---------------------------------------------------------------------------
# Phase 5: ops.gram_spec at the SV sync's shape
# ---------------------------------------------------------------------------


def run_gram_path(ops, ref, totals) -> float:
    """Returns the largest |kernel - plain| of the full-size Gram."""
    from repro_torch import device as device_mod
    from repro_torch.core.rkhs import KernelSpec
    from repro_torch.data.streams import susy_stream

    X, _ = susy_stream(BUDGET, M_KERNEL, d=D_IN, seed=0)
    X = torch.as_tensor(X.reshape(-1, D_IN), device=device_mod.resolve())
    spec = KernelSpec("gaussian", gamma=GAMMA)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    K = ops.gram_spec(spec, X, X)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(ops.LAUNCH_COUNTS)
    assert counts.get("gram", 0) > 0, "gram_path: gram never launched"
    totals["gram"] = totals.get("gram", 0) + counts["gram"]
    assert K.shape == (GRAM_M, GRAM_M)
    kw = dict(kind="gaussian", gamma=GAMMA)
    want = ref.gram_ref(X, X, **kw)
    err = close_dev(K, want, "gram_path", KERNEL_TOL, KERNEL_TOL)
    diag = torch.diagonal(K)
    assert float((diag - 1.0).abs().max()) <= KERNEL_TOL, "k(x, x) != 1"
    mean_k = float(K.mean())
    del K
    tf32(True)
    control = ref.gram_ref(X, X, **kw)
    tf32(False)
    control_err, bad = excess(control, want, KERNEL_TOL, KERNEL_TOL)
    assert bad > 0, f"gram_path: the TF32 control passes ({control_err})"
    emit({"phase": "gram_path", "shape": [GRAM_M, GRAM_M], "d": D_IN,
          "kernel_launches": counts, "wall_s": secs,
          "max_abs_err_vs_plain": err, "tf32_control_err": control_err,
          "tf32_control_bad": bad, "mean_k": mean_k})
    return err


def run_sync_route(ops, ref) -> dict:
    """The SV sync's compression at full size (m tau = 32768 SUSY rows,
    d = 18, tau = 1024, gaussian): ``compression.truncate`` under
    ``backend="kernels"`` (one ``quadform``, no Gram in memory) against
    ``backend="reference"`` (the plain 32768^2 Gram and form): the same
    model bitwise, epsilon within the parity pair.  Then epsilon^2 by
    each route, timed (device ms) with its peak memory above what was
    allocated before: the quadform route, the gram route (``gram``
    kernel, then the plain form on its buffer) and the plain route.
    Its launches are comparisons: they do not count for the kernels
    line."""
    from repro_torch import device as device_mod
    from repro_torch.core import compression, rkhs
    from repro_torch.core.rkhs import KernelSpec, SVModel
    from repro_torch.data.streams import susy_stream

    dev = device_mod.resolve()
    X, _ = susy_stream(BUDGET, M_KERNEL, d=D_IN, seed=0)
    sv = torch.as_tensor(X.reshape(-1, D_IN), device=dev)
    gen = torch.Generator().manual_seed(2)
    # the average of m learners: coefficients of a budget's scale over m
    alpha = (torch.randn(GRAM_M, generator=gen) / M_KERNEL).to(dev)
    f = SVModel(sv=sv, alpha=alpha,
                sv_id=torch.arange(GRAM_M, dtype=torch.int32, device=dev))
    spec = KernelSpec("gaussian", gamma=GAMMA)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got, eps = compression.truncate(spec, f, BUDGET, backend="kernels")
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCH_COUNTS)
    assert counts == {"quadform": 1}, counts
    want, ref_eps = compression.truncate(spec, f, BUDGET)
    for a, b in zip(got, want):
        assert torch.equal(a, b), "sync_route: the compressed models differ"
    err = close(eps, ref_eps, "sync_route eps")
    keep = torch.zeros(GRAM_M, dtype=torch.bool, device=dev)
    keep[torch.argsort(-alpha.abs(), stable=True)[:BUDGET]] = True
    beta = torch.where(keep, torch.zeros_like(alpha), alpha)
    routes = {
        "quadform": lambda: ops.quadform_spec(spec, sv[None], sv[None],
                                              beta[None], beta[None])[0],
        "gram": lambda: rkhs.quadform_(ops.gram_spec(spec, sv, sv), beta,
                                       beta),
        "plain": lambda: rkhs.quadform_(rkhs.gram(spec, sv, sv), beta, beta),
    }
    out = {}
    for name, fn in routes.items():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eps_sq = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        close(torch.sqrt(torch.clamp(eps_sq, min=0.0)), ref_eps,
              f"sync_route {name} eps")
        out[name] = dict(time_ms(fn, iters=10), peak_bytes=peak)
    torch.cuda.empty_cache()
    emit({"phase": "sync_route", "m_tau": GRAM_M, "tau": BUDGET, "d": D_IN,
          "eps_kernels": float(eps), "eps_reference": float(ref_eps),
          "eps_max_abs_err": err, "routes": out})
    return out


# ---------------------------------------------------------------------------
# Phase 6: LM token serving at full width
# ---------------------------------------------------------------------------


def _lm_requests(vocab: int, Request, lens=None, new_tokens=None) -> list:
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in (lens or LM_PROMPTS)]
    return [Request(uid=i, prompt=p,
                    max_new_tokens=new_tokens or LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]


def _left_padded(batch, B: int, dev) -> torch.Tensor:
    S = max(len(r.prompt) for r in batch)
    toks = np.zeros((B, S), np.int64)
    for i, r in enumerate(batch):
        toks[i, S - len(r.prompt):] = r.prompt
    return torch.as_tensor(toks, device=dev)


def _greedy_logits(api, params, tokens, vocab, forced=None):
    """The engine's batch loop at the model API: prefill, then
    LM_NEW_TOKENS - 1 decode steps.  Feeds ``forced`` (B, steps) tokens
    when given (teacher forcing), else its own greedy tokens.  Returns
    (logits per step (B, vocab) float32, the tokens fed back)."""
    B, S = tokens.shape
    caches = api.init_caches(B, LM_MAX_LEN)
    logits, caches = api.prefill(params, {"tokens": tokens}, caches)
    out, fed = [], []
    for step in range(LM_NEW_TOKENS):
        lg = logits[:, -1, :vocab].float()
        out.append(lg)
        nxt = (forced[:, step] if forced is not None
               else torch.argmax(lg, dim=-1))
        fed.append(nxt)
        if step + 1 < LM_NEW_TOKENS:
            logits, caches = api.decode(params, caches, nxt[:, None],
                                        S + step)
    return out, torch.stack(fed, dim=1)


class _StepClock:
    """Gives an engine a model API whose prefill and decode record a pair
    of CUDA events around each call and add no synchronize: an interval
    runs from the call's first enqueue to the end of its last kernel
    (the engine reads each step's tokens back, so the stream is idle
    when a decode starts)."""

    def __init__(self, eng):
        self.pairs = {"prefill": [], "decode": []}
        eng.api = dataclasses.replace(
            eng.api, prefill=self._wrap(eng.api.prefill, "prefill"),
            decode=self._wrap(eng.api.decode, "decode"))

    def _wrap(self, fn, key):
        def timed(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            self.pairs[key].append((a, b))
            return out
        return timed

    def seconds(self, key: str) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs[key]) / 1e3


def _steps(prof) -> list:
    """A served run's device timeline cut at each read back of the next
    tokens (a Memcpy DtoH; the engine reads once per step).  Per step:
    its kernels, their device seconds, the span from the previous read
    back's end to this one's, and whether ``flash`` ran (a prefill).
    Read from the profiler's own event records, as ``_device_seconds``
    (``prof.events()`` took the host 16 to 39 s a served run's profile,
    four times its run, on an H100 80GB HBM3 host at 700 W, by
    ``smoke_parts.py``)."""
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.start_ns())
    steps, cur, last_end = [], [], None
    for e in evs:
        name = e.name()
        if "DtoH" in name:
            start = last_end if last_end is not None else (
                cur[0].start_ns() if cur else e.start_ns())
            steps.append({
                "kernels": len(cur),
                "device_s": sum(x.duration_ns() for x in cur) / 1e9,
                "span_s": (e.end_ns() - start) / 1e9,
                "flash": any("flash" in x.name() for x in cur)})
            cur, last_end = [], e.end_ns()
        elif "Memcpy" not in name and "Memset" not in name:
            cur.append(e)
    return steps


class _FlashAgainstPlain:
    """While active, every ``_flash_sdpa`` call of the LM is held against
    the plain ``_sdpa`` on the same post-RoPE q, k, v, at the ``flash``
    kernel line's bf16 limit (2 ulps of the plain output plus 2e-5)."""

    def __init__(self):
        from repro_torch.models import attention
        self.mod, self.orig = attention, attention._flash_sdpa
        self.calls, self.seqs = 0, set()
        self.max_err, self.max_ulps, self.differ, self.of = 0.0, 0.0, 0, 0

    def __enter__(self):
        self.mod._flash_sdpa = self._checked
        return self

    def __exit__(self, *exc):
        self.mod._flash_sdpa = self.orig

    def _checked(self, cfg, q, k, v, causal):
        o = self.orig(cfg, q, k, v, causal)
        S = q.shape[1]
        mask = (self.mod.causal_mask(S, S, 0, 0, q.device) if causal
                else None)
        want = self.mod._sdpa(q, k, v, mask,
                              self.mod._inv_sqrt(cfg.hd)).float()
        gap = (o.float() - want).abs()
        ulp = bf16_ulp(want)
        assert bool((gap <= BF16_ULPS * ulp + KERNEL_TOL).all()), \
            f"lm_serve: a flash layer at S={S} is {float(gap.max())} " \
            f"off the plain attention"
        self.calls += 1
        self.seqs.add(S)
        self.max_err = max(self.max_err, float(gap.max()))
        # in ulps where the ulp, not the float32 floor, sets the limit
        ruled = BF16_ULPS * ulp > KERNEL_TOL
        if bool(ruled.any()):
            self.max_ulps = max(self.max_ulps,
                                float((gap[ruled] / ulp[ruled]).max()))
        self.differ += int((gap > 0).sum())
        self.of += gap.numel()
        return o


def run_lm_serve(ops, totals) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.models import build, count_params
    from repro_torch.serving.lm import LMServingEngine, Request

    cfg = get(LM_ARCH).with_(use_flash=True)
    dev = device_mod.resolve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)

    def engine():
        return LMServingEngine(cfg, params, batch_size=LM_BATCH,
                               max_len=LM_MAX_LEN)

    def requests():
        return _lm_requests(cfg.vocab, Request)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine().run(requests())
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    batches = -(-len(LM_PROMPTS) // LM_BATCH)
    assert counts.get("flash", 0) == cfg.n_layers * batches, counts
    totals["flash"] = totals.get("flash", 0) + counts["flash"]
    assert [r.uid for r in done] == list(range(len(LM_PROMPTS)))
    outputs = {r.uid: r.output for r in done}
    for r in done:
        assert len(r.output) == LM_NEW_TOKENS and r.latency_s > 0
        assert all(0 <= t < cfg.vocab for t in r.output)
    again = engine().run(requests())
    assert {r.uid: r.output for r in again} == outputs, "a repeat differs"

    # served as a user runs it: deterministic algorithms off (they fill
    # every torch.empty); prefill and decode timed by _StepClock; then a
    # profiled run for each step's kernels
    torch.use_deterministic_algorithms(False)
    try:
        eng = engine()
        clock = _StepClock(eng)
        t0 = time.perf_counter()
        served = eng.run(requests())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine().run(requests())
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(True)
    by_kernel = _device_seconds(prof)
    device_s = sum(by_kernel.values())
    steps = _steps(prof)
    pre = [x for x in steps if x["flash"]]
    dec = [x for x in steps if not x["flash"]]

    def spread(key, rows, scale=1.0):
        vals = sorted(x[key] * scale for x in rows) or [0.0]
        return {"min": vals[0], "median": vals[len(vals) // 2],
                "max": vals[-1]}

    # teacher forcing against the plain attention (use_flash=False): the
    # plain model's greedy run is the reference, the flash model is fed
    # its tokens; each flash layer is held to _sdpa on its own q, k, v
    flash_api, plain_api = build(cfg), build(cfg.with_(use_flash=False))
    reqs = requests()
    rel_err, excluded, held = 0.0, 0, 0
    with _FlashAgainstPlain() as layers:
        for b0 in range(0, len(reqs), LM_BATCH):
            batch = reqs[b0:b0 + LM_BATCH]
            tokens = _left_padded(batch, LM_BATCH, dev)
            want, ref_toks = _greedy_logits(plain_api, params, tokens,
                                            cfg.vocab)
            got, _ = _greedy_logits(flash_api, params, tokens, cfg.vocab,
                                    forced=ref_toks)
            if b0 == 0:   # the flash prefill, repeated, is bitwise
                again_logits, _ = flash_api.prefill(
                    params, {"tokens": tokens},
                    flash_api.init_caches(LM_BATCH, LM_MAX_LEN))
                assert torch.equal(again_logits[:, -1, :cfg.vocab].float(),
                                   got[0]), "a repeated prefill differs"
            for step, (g, w) in enumerate(zip(got, want)):
                diff = (g - w).abs()
                rel_err = max(rel_err, float(diff.max() / w.abs().max()))
                assert float(diff.max()) <= LOGIT_TOL * float(
                    w.abs().max()), \
                    f"lm_serve: step {step} logits differ by " \
                    f"{float(diff.max())}"
                top2 = torch.topk(w, 2, dim=-1).values
                margin = (top2[:, 0] - top2[:, 1]).tolist()
                row_diff = diff.max(dim=-1).values.tolist()
                for i, r in enumerate(batch):
                    if outputs[r.uid][:step] != ref_toks[i, :step].tolist():
                        continue          # the served run left this prefix
                    if margin[i] > 2 * row_diff[i]:
                        held += 1
                        assert outputs[r.uid][step] == int(
                            ref_toks[i, step]), \
                            f"lm_serve: uid {r.uid} step {step}"
                    else:
                        excluded += 1
    assert layers.calls >= cfg.n_layers * batches, layers.calls
    assert layers.seqs == {max(LM_PROMPTS[b:b + LM_BATCH])
                           for b in range(0, len(LM_PROMPTS), LM_BATCH)}
    generated = sum(len(o) for o in outputs.values())
    prompt_tokens = sum(LM_BATCH * max(LM_PROMPTS[b:b + LM_BATCH])
                        for b in range(0, len(LM_PROMPTS), LM_BATCH))
    prefill_s, decode_s = clock.seconds("prefill"), clock.seconds("decode")
    emit({"phase": "lm_serve", "arch": LM_ARCH, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n_params,
          "batch": LM_BATCH, "max_len": LM_MAX_LEN,
          "requests": len(done), "prompt_lens": list(LM_PROMPTS),
          "kernel_launches": counts, "init_s": init_s,
          "max_memory_allocated": peak,
          "generated_tokens": generated,
          # deterministic algorithms on (the checked runs)
          "deterministic_wall_s": det_s,
          "deterministic_tokens_per_wall_s": generated / det_s,
          # off, as served
          "wall_s": secs, "tokens_per_wall_s": generated / secs,
          "same_tokens": {r.uid: r.output for r in served} == outputs,
          "prefill_s": prefill_s, "decode_s": decode_s,
          "prefill_calls": len(clock.pairs["prefill"]),
          "decode_calls": len(clock.pairs["decode"]),
          "prefill_tokens_per_s": prompt_tokens / prefill_s,
          "device_s": device_s, "device_busy_share": device_s / secs,
          "top_kernels_s": dict(by_kernel.most_common(6)),
          "flash_device_s": sum(t for name, t in by_kernel.items()
                                if "flash" in name),
          # the profiled run, step by step
          "profiled_wall_s": prof_s, "steps_traced": len(steps),
          "prefill_steps": len(pre), "decode_steps": len(dec),
          "prefill_kernels": [x["kernels"] for x in pre],
          "prefill_device_s": [x["device_s"] for x in pre],
          "prefill_span_s": [x["span_s"] for x in pre],
          "decode_kernels_per_step": spread("kernels", dec),
          "decode_device_ms_per_step": spread("device_s", dec, 1e3),
          "decode_span_ms_per_step": spread("span_s", dec, 1e3),
          "flash_layers_checked": layers.calls,
          "flash_layer_seq_lens": sorted(layers.seqs),
          "flash_layer_max_abs_err": layers.max_err,
          "flash_layer_max_ulps": layers.max_ulps,
          "flash_layer_outputs_differing": layers.differ,
          "flash_layer_outputs": layers.of,
          "flash_vs_plain_max_rel_logit_err": rel_err,
          "tokens_held": held, "tokens_excluded": excluded,
          "latency_s": [r.latency_s for r in done]})


# ---------------------------------------------------------------------------
# Phase 12: the LM protocol trainer
# ---------------------------------------------------------------------------

TRAIN_M = 2               # learners
TRAIN_BATCH = 1           # sequences a learner a round
TRAIN_SEQ = 256           # tokens a sequence
TRAIN_T = 8               # rounds a run
TRAIN_LR = 0.05           # the reference CLI's (repro/launch/train.py)
TRAIN_PERIOD = 4          # the reference CLI's
TRAIN_TIMED_T = 4         # rounds timed without the checks
TRAIN_SMOKE_T = 6         # rounds of the card-against-CPU runs
ADAPTIVE_T = 600          # benchmarks/bench_adaptive.py's T, M, D
ADAPTIVE_M = 4
ADAPTIVE_D = 8
PROBE_T = 50              # rounds of the compile-counter runs
#: benchmarks/bench_adaptive.py:57-68, its five configs
ADAPTIVE_CONFIGS = (
    ("fixed_delta_1e-3", dict(kind="dynamic", delta=1e-3)),
    ("fixed_delta_1e1", dict(kind="dynamic", delta=1e1)),
    ("adaptive_rate10%_from_1e-3",
     dict(kind="dynamic", delta=1e-3, delta_schedule="adaptive",
          target_sync_rate=0.10, adapt_up=2.0)),
    ("adaptive_rate10%_from_1e1",
     dict(kind="dynamic", delta=1e1, delta_schedule="adaptive",
          target_sync_rate=0.10, adapt_up=2.0)),
    ("sqrt_schedule", dict(kind="dynamic", delta=5.0, delta_schedule="sqrt")),
)


class _ProtocolWatch:
    """While active, every ``protocol.apply_protocol`` call is checked:
    after a sync every learner's parameters are bitwise equal and the
    reference is bitwise the plain average of the learners it was given
    (float32 sum over learners, divided by m, rounded once); after a
    quiet round the reference is the one it was given, bitwise.  Records
    each round's flag and each learner's ||f_i - r||^2."""

    def __init__(self):
        from repro_torch.core import protocol
        self.mod, self.orig = protocol, protocol.apply_protocol
        self.flags, self.dists = [], []

    def __enter__(self):
        self.mod.apply_protocol = self._checked
        return self

    def __exit__(self, *exc):
        self.mod.apply_protocol = self.orig

    def _checked(self, cfg, stacked, state, **kw):
        from repro_torch.tree import leaves
        proto = self.mod
        self.dists.append(
            proto._sq_dist_to(stacked, state.reference).tolist())
        out, new = self.orig(cfg, stacked, state, **kw)
        synced = int(new.syncs) - int(state.syncs)
        assert synced in (0, 1), synced
        self.flags.append(bool(synced))
        if synced:
            m = leaves(out)[0].shape[0]
            for x, r, o in zip(leaves(stacked), leaves(new.reference),
                               leaves(out)):
                avg = (sum(x[i].float() for i in range(m)) / m).to(x.dtype)
                for i in range(m):
                    assert torch.equal(o[i], o[0]), "replicas differ"
                    assert torch.equal(r[i], avg), "reference != average"
        else:
            assert out is stacked
            for r, r0 in zip(leaves(new.reference), leaves(state.reference)):
                assert torch.equal(r, r0), "a quiet round moved the reference"
        return out, new


class _GradWatch:
    """While active, every ``torch.autograd.grad`` call (the trainer's
    one a learner a round) must return finite gradients only; records
    the calls and the largest |gradient| of the float32 leaves (a bf16
    Mamba-2 tree's ``A_log``, ``D`` and ``dt_bias``)."""

    def __enter__(self):
        self.orig = torch.autograd.grad
        torch.autograd.grad = self._checked
        self.calls, self.f32_leaves, self.f32_max = 0, 0, 0.0
        return self

    def __exit__(self, *exc):
        torch.autograd.grad = self.orig

    def _checked(self, outputs, inputs, *args, **kw):
        grads = self.orig(outputs, inputs, *args, **kw)
        finite = torch.stack([torch.isfinite(g).all() for g in grads])
        assert bool(finite.all()), \
            f"non-finite gradients at leaves {(~finite).nonzero().tolist()}"
        f32 = [g for g in grads if g.dtype == torch.float32]
        self.calls += 1
        self.f32_leaves = len(f32)
        if f32:
            self.f32_max = max(self.f32_max, float(torch.stack(
                [g.abs().max() for g in f32]).max()))
        return grads


def _timed_train_rounds(cfg, pcfg, opt_cfg, batches, m, dev):
    """``batches`` rounds of the trainer from seed 0, CUDA events around
    each step and the host clock around all (synchronized); returns
    (round ms, wall s, state, step)."""
    from repro_torch.launch import train

    state = train.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, m, opt_cfg,
        device=dev)
    step = train.make_train_step(cfg, pcfg, opt_cfg)
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, batch)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [a.elapsed_time(b) for a, b in events], wall, state, step


def _train_run(cfg, pcfg, opt_cfg, batches, dev, m=TRAIN_M) -> dict:
    """One trainer run of m learners from seed 0: per round the loss, the
    flag, the distances and the device ms (CUDA events), every sync
    checked by ``_ProtocolWatch``; the counters held to a host recount."""
    from repro_torch.core import protocol
    from repro_torch.launch import train
    from repro_torch.tree import leaves, tree_map

    state = train.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, m, opt_cfg,
        device=dev)
    one = tree_map(lambda x: x[0], state.params)
    charge = np.float32(2 * m * protocol.model_bytes(one))
    step = train.make_train_step(cfg, pcfg, opt_cfg)
    losses, events = [], []
    with _ProtocolWatch() as watch:
        for batch in batches:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, loss = step(state, batch)
            e1.record()
            events.append((e0, e1))
            losses.append(loss)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    assert int(state.step) == int(state.pstate.step) == len(batches)
    assert int(state.pstate.syncs) == sum(watch.flags)
    want = np.float32(0.0)
    for flag in watch.flags:
        want = np.float32(want + (charge if flag else np.float32(0.0)))
    assert float(state.pstate.bytes_sent) == float(want), \
        (float(state.pstate.bytes_sent), float(want))
    return {"state": state, "losses": losses, "flags": watch.flags,
            "dists": watch.dists, "charge": float(charge),
            "n_params": protocol.model_num_params(one),
            "checked_round_ms": [a.elapsed_time(b) for a, b in events]}


def _checked_train(name, cfg, pcfg, opt_cfg, batches, dev, m=TRAIN_M):
    """A run, then its repeat from seed 0, held to it bitwise
    (deterministic algorithms on); the repeat is dropped.  The first
    run's gradients are held finite by ``_GradWatch``, whose counts it
    returns beside its record."""
    from repro_torch.tree import leaves
    with _GradWatch() as grads:
        first = _train_run(cfg, pcfg, opt_cfg, batches, dev, m=m)
    again = _train_run(cfg, pcfg, opt_cfg, batches, dev, m=m)
    for key in ("losses", "flags", "dists"):
        assert again[key] == first[key], f"{name}: {key} differs"
    a, b = again.pop("state"), first.pop("state")
    assert float(a.pstate.last_divergence) == \
        float(b.pstate.last_divergence), name
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y), f"{name}: a repeat differs"
    assert grads.calls == m * len(batches), (name, grads.calls)
    first.update(grad_f32_leaves=grads.f32_leaves,
                 grad_max_abs_f32_leaves=grads.f32_max)
    return first


def _smoke_on_card_and_cpu(dev) -> list:
    """``qwen2_5_3b.smoke()`` in float32: the trainer on the card and on
    the CPU from one state carried across; sync rounds and bytes equal,
    losses and parameters within the parity pair."""
    from repro_torch.configs import get
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.launch import train
    from repro_torch.optim import OptimizerConfig
    from repro_torch.tree import leaves, tree_map

    cfg = get(LM_ARCH).smoke()
    out = []
    for name, opt_cfg, pcfg in (
            ("adamw_continuous",
             OptimizerConfig(kind="adamw", lr=1e-3, grad_clip=1.0),
             ProtocolConfig(kind="continuous")),
            ("sgd_momentum_dynamic_per_group",
             OptimizerConfig(kind="sgd", lr=0.05, momentum=0.9,
                             grad_clip=1.0),
             ProtocolConfig(kind="dynamic", delta=0.05, per_group=True))):
        step = train.make_train_step(cfg, pcfg, opt_cfg)
        cpu = train.init_train_state(0, cfg, TRAIN_M, opt_cfg, device="cpu")
        card = tree_map(lambda x: x.to(dev) if torch.is_tensor(x) else x, cpu)
        rng = np.random.default_rng(0)
        loss_err = 0.0
        for t in range(TRAIN_SMOKE_T):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                                (TRAIN_M, 2, 17)))
            batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
            cpu, lc = step(cpu, batch)
            card, lg = step(card, {k: v.to(dev) for k, v in batch.items()})
            assert int(card.pstate.syncs) == int(cpu.pstate.syncs), (name, t)
            assert float(card.pstate.bytes_sent) == \
                float(cpu.pstate.bytes_sent), (name, t)
            loss_err = max(loss_err, close(lg.cpu(), lc, f"{name} loss {t}"))
        param_err = max(close(g.cpu(), w, f"{name} params")
                        for g, w in zip(leaves(card.params),
                                        leaves(cpu.params)))
        out.append({"run": name, "rounds": TRAIN_SMOKE_T,
                    "syncs": int(cpu.pstate.syncs),
                    "bytes_sent": float(cpu.pstate.bytes_sent),
                    "loss_max_abs_err": loss_err,
                    "param_max_abs_err": param_err})
    return out


def _adaptive_on_card_and_cpu(dev) -> list:
    """benchmarks/bench_adaptive.py's protocol (linear hinge learners on
    a drifting stream, its five configs) through
    ``protocol.make_protocol_step`` on the card and on the CPU: equal
    sync counts and bytes."""
    from repro_torch.core import protocol
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data.streams import drifting_stream

    def local_update(model, ex):
        x, y = ex
        ell = torch.clamp(1.0 - y * (model["w"] @ x), min=0.0)
        g = torch.where(ell > 0, -y, torch.zeros_like(y))
        return {"w": model["w"] - 0.2 * g * x}, ell

    X, Y = drifting_stream(ADAPTIVE_T, ADAPTIVE_M, d=ADAPTIVE_D, seed=0,
                           drift_every=ADAPTIVE_T // 4)
    out = []
    for name, kw in ADAPTIVE_CONFIGS:
        step = protocol.make_protocol_step(ProtocolConfig(**kw), local_update)
        got = {}
        for where in ("cpu", dev):
            Xd = torch.as_tensor(X, device=where)
            Yd = torch.as_tensor(Y, device=where)
            st = {"w": torch.zeros((ADAPTIVE_M, ADAPTIVE_D), device=where)}
            state = protocol.init_state(
                {"w": torch.zeros((ADAPTIVE_D,), device=where)}, ADAPTIVE_M)
            t0 = time.perf_counter()
            half = 0
            for t in range(ADAPTIVE_T):
                st, state, _ = step(st, state, (Xd[t], Yd[t]))
                if t == ADAPTIVE_T // 2:
                    half = int(state.syncs)
            got[str(where)] = (int(state.syncs), float(state.bytes_sent),
                               (int(state.syncs) - half)
                               / (ADAPTIVE_T - ADAPTIVE_T // 2),
                               time.perf_counter() - t0)
        card, cpu = got[str(dev)], got["cpu"]
        assert card[:2] == cpu[:2], (name, card, cpu)
        out.append({"config": name, "syncs": card[0], "bytes_sent": card[1],
                    "rate_second_half": card[2],
                    "card_rounds_per_s": ADAPTIVE_T / card[3],
                    "cpu_rounds_per_s": ADAPTIVE_T / cpu[3]})
    return out


def _compile_counts(dev) -> dict:
    """A second value-equal ``engine.run`` of ``sv_dynamic`` and a second
    ``engine.sweep`` of the warm RFF group compile nothing."""
    from repro_torch.core import engine
    from repro_torch.data.streams import susy_stream
    from repro_torch.telemetry import CompileCounter

    configs = {name: (learner, m, pcfg)
               for name, learner, m, pcfg, _ in e2e_configs()}
    out = {}
    learner, m, pcfg = configs["sv_dynamic"]
    X, Y = susy_stream(PROBE_T, m, d=D_IN, seed=0)
    with CompileCounter() as first:
        a = engine.run(learner, pcfg, X, Y, backend="kernels", device=dev)
    with CompileCounter() as second:
        b = engine.run(dataclasses.replace(learner),
                       dataclasses.replace(pcfg), X, Y, backend="kernels",
                       device=dev)
    assert second.compiles == 0, second.events
    _assert_same_result(a, b, "probe sv_dynamic")
    out["engine_run"] = {"first": first.compiles, "second": second.compiles}
    name, learner, m, grid, *_ = next(c for c in sweep_configs()
                                      if c[0] == "sweep_rff_dynamic")
    X, Y = susy_stream(PROBE_T, m, d=D_IN, seed=0)
    with CompileCounter() as first:
        engine.sweep(learner, grid, X, Y, backend="kernels", device=dev)
    with CompileCounter() as second:
        engine.sweep(learner, list(grid), X, Y, backend="kernels", device=dev)
    assert second.compiles == 0, second.events
    out["engine_sweep"] = {"first": first.compiles, "second": second.compiles}
    return out


def _checkpoint_round_trip(dev) -> dict:
    """A smoke ``TrainState`` (bf16) saved on the card restores bitwise."""
    import shutil

    from repro_torch import checkpoint
    from repro_torch.configs import get
    from repro_torch.launch import train
    from repro_torch.optim import OptimizerConfig
    from repro_torch.tree import leaves

    cfg = get(LM_ARCH).smoke().with_(dtype="bfloat16")
    opt_cfg = OptimizerConfig(kind="adamw", lr=1e-3)
    state = train.init_train_state(0, cfg, TRAIN_M, opt_cfg, device=dev)
    d = OUT_DIR / "train_ckpt"
    try:
        path = checkpoint.save_step(str(d), 0, state)
        assert checkpoint.latest_step(str(d)) == path
        got = checkpoint.restore(path, train.init_train_state(
            1, cfg, TRAIN_M, opt_cfg, device=dev))
        n = 0
        for g, w in zip(leaves(got), leaves(state)):
            assert g.device == w.device and torch.equal(g, w), "restore differs"
            n += 1
        size = Path(path).stat().st_size
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"leaves": n, "bytes": size}


def run_train_phase(ops) -> None:
    """The LM protocol trainer at ``qwen2_5_3b``'s full width and depth
    (36 layers, d 2048, bf16, ``use_flash=False``), m = 2 learners of 1 x
    256 tokens a round from ``token_stream(seed=0)``, sgd (lr 0.05,
    momentum 0, clip 1.0): ``train_periodic`` (period 4) and
    ``train_dynamic`` (mini_batch 1, delta between the smallest and the
    largest distance ``train_periodic`` recorded), T = 8 each, each run
    twice from seed 0 and held bitwise to itself.  Then the smoke runs on
    the card against the CPU, the Sec. 4 controller, a checkpoint round
    trip and the compile counters."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data.streams import token_stream
    from repro_torch.optim import OptimizerConfig
    from repro_torch.telemetry import time_fn

    t_phase = time.perf_counter()
    cfg = get(LM_ARCH).with_(use_flash=False)
    dev = device_mod.resolve()
    opt_cfg = OptimizerConfig(kind="sgd", lr=TRAIN_LR, momentum=0.0,
                              grad_clip=1.0)
    batches = []
    for toks, labels in token_stream(TRAIN_T, TRAIN_M * TRAIN_BATCH,
                                     TRAIN_SEQ, cfg.vocab, seed=0):
        shape = (TRAIN_M, TRAIN_BATCH, TRAIN_SEQ)
        batches.append({
            "tokens": torch.as_tensor(toks, dtype=torch.int64,
                                      device=dev).reshape(shape),
            "labels": torch.as_tensor(labels, dtype=torch.int64,
                                      device=dev).reshape(shape)})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def checked(name, pcfg):
        return _checked_train(name, cfg, pcfg, opt_cfg, batches, dev)

    periodic = ProtocolConfig(kind="periodic", period=TRAIN_PERIOD)
    runs = {"train_periodic": checked("train_periodic", periodic)}
    rec = runs["train_periodic"]
    assert sum(rec["flags"]) == TRAIN_T // TRAIN_PERIOD
    # the dynamic threshold: between the first round's distance and the
    # largest before the first periodic sync (the two runs agree until a
    # first sync), so the dynamic run has quiet rounds and sync rounds
    lo = max(rec["dists"][0])
    hi = max(max(d) for d in rec["dists"][:TRAIN_PERIOD])
    every = [x for d in rec["dists"] for x in d]
    delta = float(np.sqrt(lo * hi))
    assert min(every) < delta < max(every) and lo < delta < hi, (lo, hi)
    dynamic = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=1)
    runs["train_dynamic"] = checked("train_dynamic", dynamic)
    assert 0 < sum(runs["train_dynamic"]["flags"]) < TRAIN_T, \
        runs["train_dynamic"]["flags"]
    launches = dict(ops.LAUNCH_COUNTS)
    assert not launches, f"the trainer launched {launches}"
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    assert peak < total, (peak, total)

    # the rounds without the checks: CUDA events around each step, from
    # seed 0, first with deterministic algorithms on (as the checked
    # runs), then off as a user runs them and as lm_serve is timed (the
    # mode fills every torch.empty, each round's new parameter stack
    # too); with the mode off one more round by the probe's time_fn and
    # one profiled
    def timed_rounds():
        round_ms, _, state, step = _timed_train_rounds(
            cfg, dynamic, opt_cfg, batches[:TRAIN_TIMED_T], TRAIN_M, dev)
        assert int(state.pstate.syncs) == \
            sum(runs["train_dynamic"]["flags"][:TRAIN_TIMED_T])
        return round_ms, state, step

    det_round_ms = timed_rounds()[0]
    torch.use_deterministic_algorithms(False)
    try:
        retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        round_ms, state, step = timed_rounds()
        retries1 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        timed = time_fn(step, state, batches[0], warmup=1, iters=2)
        retries2 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, c0 = time.perf_counter(), time.process_time()
            step(state, batches[0])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            prof_cpu = time.process_time() - c0
    finally:
        torch.use_deterministic_algorithms(True)
    by_kernel = _device_seconds(prof)
    device_s = sum(by_kernel.values())
    activities = sum(1 for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
    del state, step
    torch.cuda.empty_cache()
    tokens = TRAIN_M * TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(round_ms[1:])
    median_ms = steady[len(steady) // 2]
    det = sorted(det_round_ms[1:])
    det_median_ms = det[len(det) // 2]
    for name, r in runs.items():
        emit({"phase": "train", "run": name, "arch": LM_ARCH,
              "n_layers": cfg.n_layers, "d_model": cfg.d_model,
              "dtype": cfg.dtype, "use_flash": cfg.use_flash,
              "params": r["n_params"], "m": TRAIN_M,
              "tokens_per_round": tokens, "T": TRAIN_T,
              "optimizer": dataclasses.asdict(opt_cfg),
              "protocol": dataclasses.asdict(
                  periodic if name == "train_periodic" else dynamic),
              "losses": r["losses"], "sync_rounds": [
                  t + 1 for t, f in enumerate(r["flags"]) if f],
              "dists": r["dists"], "bytes_per_sync": r["charge"],
              "checked_round_ms": r["checked_round_ms"],
              "repeat_bitwise": True})
    smoke = _smoke_on_card_and_cpu(dev)
    adaptive = _adaptive_on_card_and_cpu(dev)
    ckpt = _checkpoint_round_trip(dev)
    compiles = _compile_counts(dev)
    emit({"phase": "train_checks", "dynamic_delta": delta,
          "periodic_dist_range": [min(every), max(every)],
          # train_dynamic's rounds without the checks, deterministic
          # algorithms off
          "round_ms": round_ms, "median_round_ms": median_ms,
          "tokens_per_s": tokens / (median_ms / 1e3),
          # the same rounds with the mode on
          "deterministic_round_ms": det_round_ms,
          "deterministic_median_round_ms": det_median_ms,
          "deterministic_tokens_per_s": tokens / (det_median_ms / 1e3),
          "trainer_kernel_launches": launches,
          "max_memory_allocated": peak, "device_memory": total,
          "time_fn_round_ms": timed.us_per_call / 1e3,
          "time_fn_compiles": timed.compiles,
          "time_fn_warmup_compiles": timed.warmup_compiles,
          "time_fn_tokens_per_s": tokens / (timed.us_per_call / 1e6),
          # the caching allocator's cudaFree-and-retry events
          "alloc_retries_timed_rounds": retries1 - retries0,
          "alloc_retries_time_fn": retries2 - retries1,
          "profiled_round_wall_s": prof_wall, "profiled_device_s": device_s,
          "device_busy_share": device_s / prof_wall,
          # the profiled round's process CPU seconds and device activities
          # (kernels, copies, fills)
          "profiled_round_cpu_s": prof_cpu,
          "profiled_device_activities": activities,
          "top_kernels_s": dict(by_kernel.most_common(6)),
          "smoke_card_vs_cpu": smoke, "adaptive_card_vs_cpu": adaptive,
          "checkpoint": ckpt, "compile_counts": compiles,
          "phase_wall_s": time.perf_counter() - t_phase})


# ---------------------------------------------------------------------------
# Phase 13: the Mamba-2 SSM family (trainer and serving)
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2_130m"
SSM_M = 4                 # the reference CLI's learners
SSM_BATCH = 2             # sequences a learner a round
SSM_SEQ = 512             # tokens a sequence: four chunks of 128
SSM_T = 8                 # rounds a checked run
SSM_TIMED_T = 4           # rounds timed without the checks
SSM_PARAMS = 129_100_224  # jax.eval_shape of the reference's init
SSM_MODEL_BYTES = 258_203_904
SSM_F32_PROMPT = 1500     # the float32 prefill -> decode check
SSM_F32_STEPS = 31


def _ssm_train(ops, cfg, dev) -> dict:
    """The trainer at ``mamba2_130m``'s full width: the checked periodic
    and dynamic runs (each repeated bitwise from seed 0), then the timed
    rounds.  Returns the phase line's ``train`` object."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data.streams import token_stream
    from repro_torch.optim import OptimizerConfig

    opt_cfg = OptimizerConfig(kind="sgd", lr=TRAIN_LR, momentum=0.0,
                              grad_clip=1.0)
    shape = (SSM_M, SSM_BATCH, SSM_SEQ)
    batches = [{"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                          device=dev).reshape(shape),
                "labels": torch.as_tensor(labels, dtype=torch.int64,
                                          device=dev).reshape(shape)}
               for toks, labels in token_stream(
                   SSM_T, SSM_M * SSM_BATCH, SSM_SEQ, cfg.vocab, seed=0)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def checked(name, pcfg):
        rec = _checked_train(name, cfg, pcfg, opt_cfg, batches, dev, m=SSM_M)
        assert rec["grad_f32_leaves"] == 3 * cfg.n_layers, rec
        assert rec["grad_max_abs_f32_leaves"] > 0.0, \
            "no gradient reached A_log, D, dt_bias"
        return rec

    periodic = ProtocolConfig(kind="periodic", period=TRAIN_PERIOD)
    runs = {"train_periodic": checked("ssm periodic", periodic)}
    rec = runs["train_periodic"]
    assert rec["n_params"] == SSM_PARAMS, rec["n_params"]
    assert rec["charge"] == 2 * SSM_M * SSM_MODEL_BYTES, rec["charge"]
    assert sum(rec["flags"]) == SSM_T // TRAIN_PERIOD
    lo = max(rec["dists"][0])
    hi = max(max(d) for d in rec["dists"][:TRAIN_PERIOD])
    every = [x for d in rec["dists"] for x in d]
    delta = float(np.sqrt(lo * hi))
    assert min(every) < delta < max(every) and lo < delta < hi, (lo, hi)
    dynamic = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=1)
    runs["train_dynamic"] = checked("ssm dynamic", dynamic)
    assert 0 < sum(runs["train_dynamic"]["flags"]) < SSM_T, \
        runs["train_dynamic"]["flags"]
    launches = dict(ops.LAUNCH_COUNTS)
    assert not launches, f"the SSM trainer launched {launches}"
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    timed = batches[:SSM_TIMED_T]
    det_ms, det_wall = _timed_train_rounds(cfg, dynamic, opt_cfg, timed,
                                           SSM_M, dev)[:2]
    torch.use_deterministic_algorithms(False)
    try:
        round_ms, wall, state, step = _timed_train_rounds(
            cfg, dynamic, opt_cfg, timed, SSM_M, dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, c0 = time.perf_counter(), time.process_time()
            step(state, batches[0])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            prof_cpu = time.process_time() - c0
    finally:
        torch.use_deterministic_algorithms(True)
    del state, step
    by_kernel = _device_seconds(prof)
    device_s = sum(by_kernel.values())
    activities = sum(1 for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
    tokens = SSM_M * SSM_BATCH * SSM_SEQ

    def median(xs):
        xs = sorted(xs[1:])
        return xs[len(xs) // 2]

    return {
        "m": SSM_M, "tokens_per_round": tokens, "T": SSM_T,
        "optimizer": dataclasses.asdict(opt_cfg), "dynamic_delta": delta,
        "runs": {name: {
            "protocol": dataclasses.asdict(
                periodic if name == "train_periodic" else dynamic),
            "losses": r["losses"], "sync_rounds": [
                t + 1 for t, f in enumerate(r["flags"]) if f],
            "dists": r["dists"], "bytes_per_sync": r["charge"],
            "grad_max_abs_f32_leaves": r["grad_max_abs_f32_leaves"],
            "checked_round_ms": r["checked_round_ms"],
            "repeat_bitwise": True} for name, r in runs.items()},
        "params": SSM_PARAMS, "model_bytes": SSM_MODEL_BYTES,
        "kernel_launches": launches, "max_memory_allocated": peak,
        # train_dynamic's rounds without the checks, deterministic
        # algorithms off, then on
        "round_ms": round_ms, "median_round_ms": median(round_ms),
        "tokens_per_s": tokens / (median(round_ms) / 1e3),
        "timed_wall_s": wall,
        "tokens_per_wall_s": tokens * len(timed) / wall,
        "deterministic_round_ms": det_ms,
        "deterministic_tokens_per_wall_s": tokens * len(timed) / det_wall,
        "profiled_round_wall_s": prof_wall, "profiled_round_cpu_s": prof_cpu,
        "profiled_device_s": device_s,
        "device_busy_share": device_s / prof_wall,
        "profiled_device_activities": activities,
        "top_kernels_s": dict(by_kernel.most_common(6))}


def _ssm_serve(ops, cfg, params, dev) -> dict:
    """``LMServingEngine`` with the SSM: two batches of four of
    ``LM_PROMPTS``, 32 new tokens (``_serve_checked``)."""
    return _serve_checked(ops, cfg, params, "SSM serving")


def _serve_checked(ops, cfg, params, label, prompts=None, max_len=None,
                   new_tokens=None, expect=None, watch=None) -> dict:
    """``LMServingEngine`` at batch ``LM_BATCH`` on ``prompts`` (default
    ``LM_PROMPTS``, ``LM_MAX_LEN``, ``LM_NEW_TOKENS``): the first run
    inside the context ``watch()`` returns, when given, and launching
    exactly ``expect`` (default none), a repeat bitwise launching the
    same; then served with deterministic algorithms off (tokens per wall
    second, prefill and decode seconds) and profiled (device activities
    a decode step)."""

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.lm import LMServingEngine, Request

    prompts = prompts or LM_PROMPTS
    max_len = max_len or LM_MAX_LEN
    new_tokens = new_tokens or LM_NEW_TOKENS

    def engine():
        return LMServingEngine(cfg, params, batch_size=LM_BATCH,
                               max_len=max_len)

    def requests():
        return _lm_requests(cfg.vocab, Request, prompts, new_tokens)

    expect = expect or {}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with (watch() if watch else contextlib.nullcontext()):
        done = engine().run(requests())
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ops.LAUNCH_COUNTS)
    assert launches == expect, f"{label} launched {launches}"
    outputs = {r.uid: r.output for r in done}
    assert sorted(outputs) == list(range(len(prompts)))
    for r in done:
        assert len(r.output) == new_tokens and r.latency_s > 0
        assert all(0 <= t < cfg.vocab for t in r.output)
    ops.reset_launch_counts()
    again = engine().run(requests())
    assert {r.uid: r.output for r in again} == outputs, "a repeat differs"
    assert dict(ops.LAUNCH_COUNTS) == expect, \
        f"{label}'s repeat launched {dict(ops.LAUNCH_COUNTS)}"

    torch.use_deterministic_algorithms(False)
    try:
        eng = engine()
        clock = _StepClock(eng)
        t0 = time.perf_counter()
        served = eng.run(requests())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine().run(requests())
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(True)
    device_s = sum(_device_seconds(prof).values())
    # each batch reads its tokens back new_tokens times: after the
    # prefill, then after each decode step.  Late in this process the
    # profiler can lose a read back, which merges two steps, so the
    # decode figures are medians over the steps below the prefills'
    # count of largest ones
    steps = _steps(prof)
    batches = -(-len(prompts) // LM_BATCH)
    dec = sorted(steps, key=lambda x: x["kernels"])[:-batches]
    generated = sum(len(o) for o in outputs.values())
    prefill_s, decode_s = clock.seconds("prefill"), clock.seconds("decode")

    def median(key, scale=1):
        vals = sorted(x[key] * scale for x in dec)
        return vals[len(vals) // 2] if vals else None

    return {"batch": LM_BATCH, "requests": len(done),
            "prompt_lens": list(prompts), "new_tokens": new_tokens,
            "kernel_launches": launches, "max_memory_allocated": peak,
            "generated_tokens": generated,
            "deterministic_wall_s": det_s,
            "wall_s": secs, "tokens_per_wall_s": generated / secs,
            "same_tokens": {r.uid: r.output for r in served} == outputs,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "decode_calls": len(clock.pairs["decode"]),
            "decode_ms_per_step": decode_s * 1e3
            / max(len(clock.pairs["decode"]), 1),
            "profiled_wall_s": prof_s, "device_s": device_s,
            "device_busy_share": device_s / prof_s,
            "steps_traced": len(steps),
            "steps_expected": batches * new_tokens,
            "decode_kernels_per_step_median": median("kernels"),
            "decode_device_ms_per_step_median": median("device_s", 1e3),
            "decode_span_ms_per_step_median": median("span_s", 1e3)}


def _ssm_decode_f32(cfg, params, dev) -> dict:
    """The same weights in float32: prefill of ``SSM_F32_PROMPT`` tokens
    (padded to a multiple of the chunk inside), then ``SSM_F32_STEPS``
    teacher-forced decode steps, each step's logits within ``LOGIT_TOL``
    of the largest logit of one full forward at that position
    (tests/test_decode.py:37; ``_f32_against_full``)."""
    from repro_torch.models import build
    from repro_torch.tree import tree_map

    cfg32 = cfg.with_(dtype="float32")
    p32 = tree_map(lambda x: x.float(), params)
    api = build(cfg32)
    n = SSM_F32_PROMPT + SSM_F32_STEPS
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, n)), device=dev)
    short, long_ = api.init_caches(LM_BATCH, 8), api.init_caches(LM_BATCH,
                                                                 LM_MAX_LEN)
    assert [tuple(c.h.shape) + tuple(c.conv_buf.shape) for c in short] == \
        [tuple(c.h.shape) + tuple(c.conv_buf.shape) for c in long_]
    del short, long_
    rec, _ = _f32_against_full(api, p32, tokens, SSM_F32_PROMPT,
                               SSM_F32_STEPS, 8, "lm_ssm")
    del p32
    return {k: rec[k] for k in ("prompt", "decode_steps",
                                "max_rel_logit_err", "tol")}


def run_ssm_phase(ops) -> None:
    """Phase 13 (``lm_ssm``): ``mamba2_130m`` at full width and depth (24
    layers, d 768, bf16 with float32 ``A_log``, ``D`` and ``dt_bias``;
    weights drawn on the card from seed 0): the protocol trainer
    (``_ssm_train``), serving (``_ssm_serve``) and the float32 prefill
    and decode against a full forward (``_ssm_decode_f32``)."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.models import build, count_params

    t_phase = time.perf_counter()
    cfg = get(SSM_ARCH)
    dev = device_mod.resolve()
    torch.cuda.empty_cache()
    line = {"phase": "lm_ssm", "arch": SSM_ARCH, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype,
            "train": _ssm_train(ops, cfg, dev)}
    torch.cuda.empty_cache()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    assert count_params(params) == SSM_PARAMS
    line["serve"] = _ssm_serve(ops, cfg, params, dev)
    line["f32"] = _ssm_decode_f32(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit(line)


# ---------------------------------------------------------------------------
# Phase 14: the dense configs granite_8b and qwen3_14b, served with flash
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("granite_8b", "qwen3_14b")
DENSE_PROMPTS = (1024, 700, 333, 64)
DENSE_NEW_TOKENS = 8


def run_dense_phase(ops, totals, flashmod, ref) -> dict:
    """Phase 14 (``lm_dense``): each config at full width and depth (bf16,
    ``use_flash=True``, weights drawn on the card from seed 0), one at a
    time: ``LMServingEngine`` at batch 4 on ``DENSE_PROMPTS``,
    ``DENSE_NEW_TOKENS`` new tokens, every flash layer held to the plain
    attention on its own q, k, v (``_FlashAgainstPlain``), a repeat
    bitwise, then a served run with deterministic algorithms off; and
    ``flash`` timed at the prefill's shape.  Returns the kernels line's
    ``lm_dense_shapes`` for ``flash``."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.models import build, count_params
    from repro_torch.serving.lm import LMServingEngine, Request

    dev = device_mod.resolve()
    shapes = {}
    for arch in DENSE_ARCHS:
        t_arch = time.perf_counter()
        cfg = get(arch).with_(use_flash=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
        n_params = count_params(params)
        max_len = max(DENSE_PROMPTS) + DENSE_NEW_TOKENS

        def engine():
            return LMServingEngine(cfg, params, batch_size=LM_BATCH,
                                   max_len=max_len)

        def requests():
            rng = np.random.default_rng(0)
            return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n),
                            max_new_tokens=DENSE_NEW_TOKENS)
                    for i, n in enumerate(DENSE_PROMPTS)]

        ops.reset_launch_counts()
        with _FlashAgainstPlain() as layers:
            done = engine().run(requests())
        counts = dict(ops.LAUNCH_COUNTS)
        assert counts == {"flash": cfg.n_layers}, counts
        assert layers.calls == cfg.n_layers, layers.calls
        assert layers.seqs == {max(DENSE_PROMPTS)}, layers.seqs
        totals["flash"] = totals.get("flash", 0) + counts["flash"]
        outputs = {r.uid: r.output for r in done}
        for r in done:
            assert len(r.output) == DENSE_NEW_TOKENS
            assert all(0 <= t < cfg.vocab for t in r.output)
        again = engine().run(requests())
        assert {r.uid: r.output for r in again} == outputs, \
            f"{arch}: a repeat differs"
        torch.use_deterministic_algorithms(False)
        try:
            t0 = time.perf_counter()
            served = engine().run(requests())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(True)
        peak = torch.cuda.max_memory_allocated()
        del params
        torch.cuda.empty_cache()
        BH = LM_BATCH * cfg.n_heads
        ms, plain, library, (bms, by), gemm, _ = flash_timing(
            flashmod, ref, BH, max(DENSE_PROMPTS), cfg.hd, LM_BATCH, dev,
            torch.Generator().manual_seed(0))
        shapes[arch] = {
            "shape": [BH, max(DENSE_PROMPTS), cfg.hd], "launches": counts[
                "flash"], "ms": ms["ms"], "device_ms": ms["device_ms"],
            "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
            "library_ms": library["ms"],
            "library_device_ms": library["device_ms"],
            "bound_ms": bms, "bound_by": by,
            "attention_tflops": gemm * 2 / ms["device_ms"] / 1e9}
        generated = sum(len(o) for o in outputs.values())
        emit({"phase": "lm_dense", "arch": arch, "n_layers": cfg.n_layers,
              "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
              "hd": cfg.hd, "qk_norm": cfg.qk_norm, "dtype": cfg.dtype,
              "params": n_params, "batch": LM_BATCH,
              "prompt_lens": list(DENSE_PROMPTS),
              "new_tokens": DENSE_NEW_TOKENS, "kernel_launches": counts,
              "max_memory_allocated": peak, "generated_tokens": generated,
              "wall_s": secs, "tokens_per_wall_s": generated / secs,
              "same_tokens": {r.uid: r.output for r in served} == outputs,
              "flash_layers_checked": layers.calls,
              "flash_layer_max_abs_err": layers.max_err,
              "flash_layer_max_ulps": layers.max_ulps,
              "flash_layer_outputs_differing": layers.differ,
              "flash_layer_outputs": layers.of,
              "flash": shapes[arch],
              "arch_wall_s": time.perf_counter() - t_arch})
    return shapes


# ---------------------------------------------------------------------------
# Phase 15: long-context serving -- the ring cache, the RG-LRU hybrid and
# the long_500k policy
# ---------------------------------------------------------------------------

LONG_ARCH = "recurrentgemma_9b"
LONG_PARAMS = 9_396_408_320       # jax.eval_shape of the reference's init
LONG_MODEL_BYTES = 18_793_029_632
LONG_MAX_LEN = 4096               # rings of min(4096, window 2048) slots
LONG_PROMPTS = (64, 700, 2100, 3000)
LONG_NEW_TOKENS = 32
LONG_F32_PROMPT = 2100            # the float32 prefill -> decode check
LONG_F32_STEPS = 16
DECODE_32K_PROMPT = 128           # the decode_32k shape: batch 128
DECODE_32K_STEPS = 8
DECODE_32K_CACHE_BYTES = 3_357_638_656
DENSE_LONG_ARCH = "qwen2_5_3b"    # variant_for(., "long_500k"): window 4096
DENSE_LONG_WINDOW = 4096
DENSE_LONG_PROMPT = 6000
DENSE_LONG_STEPS = 32
DENSE_LONG_CACHE_BYTES_F32 = 302_579_712
LONG_TRAIN_LAYERS = 3             # one (rglru, rglru, attn) unit
LONG_TRAIN_SEQ = 2304             # 2048 + 256: the window cuts the mask
LONG_TRAIN_PARAMS = 1_705_078_784
LONG_TRAIN_MODEL_BYTES = 3_410_173_952


class _RingWatch:
    """While active, records each prefill's cache fill as (tokens,
    ring slots) (``transformer._fill_kv_cache``)."""

    def __init__(self):
        from repro_torch.models import transformer
        self.mod, self.orig = transformer, transformer._fill_kv_cache
        self.fills = []

    def __enter__(self):
        self.mod._fill_kv_cache = self._record
        return self

    def __exit__(self, *exc):
        self.mod._fill_kv_cache = self.orig

    def _record(self, cfg, cache, kv, S):
        self.fills.append((S, cache.length))
        return self.orig(cfg, cache, kv, S)


def _f32_against_full(api, params, tokens, prompt, steps, length,
                      label, embeds=None, frames=None) -> dict:
    """Prefill ``prompt`` tokens (after ``embeds``, a VLM's prefix, or
    beside ``frames``, an encoder-decoder's input, when given), then
    ``steps`` teacher-forced decode steps; each step's logits within
    ``LOGIT_TOL`` of the largest logit of one full forward at that
    position (tests/test_decode.py:37; the encoder-decoder's full
    forward is ``decode_train``).  Returns the worst error and the
    caches' leaves."""
    from repro_torch.tree import leaves

    vocab = api.cfg.vocab
    prefix = {} if embeds is None else {"embeds": embeds}
    if frames is not None:
        prefix["frames"] = frames
    extra = 0 if embeds is None else embeds.shape[1]
    caches = api.init_caches(tokens.shape[0], length)
    with torch.no_grad():
        full = api.forward(params, {"tokens": tokens, **prefix})[0][
            ..., :vocab]
        logits, caches = api.prefill(
            params, {"tokens": tokens[:, :prompt], **prefix}, caches)
        worst = 0.0
        for step in range(steps + 1):
            pos = prompt - 1 + step
            got, want = logits[:, -1, :vocab], full[:, extra + pos]
            rel = float((got - want).abs().max() / want.abs().max())
            assert rel <= LOGIT_TOL, \
                f"{label}: float32 step {step} is {rel} of the largest logit"
            worst = max(worst, rel)
            if step < steps:
                logits, caches = api.decode(
                    params, caches, tokens[:, pos + 1:pos + 2],
                    extra + pos + 1)
    del full
    return {"prompt": prompt, "prefix": extra, "decode_steps": steps,
            "max_rel_logit_err": worst, "tol": LOGIT_TOL,
            "cache_bytes": sum(x.numel() * x.element_size()
                               for x in leaves(caches))}, caches


def _long_decode_32k(ops, cfg, params, dev) -> dict:
    """``make_decode_step`` at ``input_specs(cfg, "decode_32k")``'s batch
    and caches: the caches allocated with ``init_caches(128, 32768 +
    CACHE_MARGIN)``, each leaf the spec's shape and dtype, filled by a
    batch-128 prefill of 128-token prompts; 8 greedy decode steps, their
    logits finite, twice, bitwise; then timed with deterministic
    algorithms off."""
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.launch.specs import CACHE_MARGIN, SHAPES, input_specs
    from repro_torch.models import build
    from repro_torch.tree import leaves

    api = build(cfg)
    shape = SHAPES["decode_32k"]
    B, seq = shape["batch"], shape["seq"]
    specs = input_specs(cfg, "decode_32k")
    serve_step = make_decode_step(cfg)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, DECODE_32K_PROMPT)), device=dev)

    def run(timed=False):
        caches = api.init_caches(B, seq + CACHE_MARGIN)
        got, want = leaves(caches), leaves(specs["caches"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape,
                                                               w.shape)
        nbytes = sum(x.numel() * x.element_size() for x in got)
        assert nbytes == DECODE_32K_CACHE_BYTES, nbytes
        with torch.no_grad():
            logits, caches = api.prefill(params, {"tokens": prompts}, caches)
            nxt = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
            toks, events = [nxt], []
            for i in range(DECODE_32K_STEPS):
                pos = DECODE_32K_PROMPT + i
                if timed:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    nxt, caches = serve_step(params, caches, nxt, pos)
                    e1.record()
                    events.append((e0, e1))
                else:
                    logits, caches = api.decode(params, caches, nxt, pos)
                    assert bool(torch.isfinite(logits).all()), pos
                    nxt = torch.argmax(logits[:, -1, :cfg.vocab],
                                       dim=-1)[:, None]
                toks.append(nxt)
        torch.cuda.synchronize()
        return torch.cat(toks, 1), [a.elapsed_time(b) for a, b in events], \
            nbytes

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    first, _, nbytes = run()
    again, _, _ = run()
    assert torch.equal(first, again), "decode_32k: a repeat differs"
    launches = dict(ops.LAUNCH_COUNTS)
    assert not launches, f"decode_32k launched {launches}"
    torch.use_deterministic_algorithms(False)
    try:
        timed, step_ms, _ = run(timed=True)
    finally:
        torch.use_deterministic_algorithms(True)
    peak = torch.cuda.max_memory_allocated()
    med = sorted(step_ms)[len(step_ms) // 2]
    return {"batch": B, "cache_len": seq + CACHE_MARGIN,
            "ring_slots": cfg.window, "cache_bytes": nbytes,
            "prompt": DECODE_32K_PROMPT, "steps": DECODE_32K_STEPS,
            "repeat_bitwise": True, "logits_finite": True,
            "kernel_launches": launches, "step_ms": step_ms,
            "median_step_ms": med, "tokens_per_s": B / (med / 1e3),
            "same_tokens_timed": bool(torch.equal(timed, first)),
            "max_memory_allocated": peak}


def _dense_long(ops, dev) -> dict:
    """``variant_for(qwen2_5_3b, "long_500k")`` (window 4096) with
    ``use_flash=True``, in float32 at B 1: a 6,000-token prefill (the
    ring path) and 32 teacher-forced decode steps against the windowed
    full forward; caches of ``input_specs``' shapes (4096 slots a layer
    whatever the context); no ``flash`` launch."""
    from repro_torch.configs import get
    from repro_torch.launch.specs import CACHE_MARGIN, SHAPES, input_specs, \
        variant_for
    from repro_torch.models import build
    from repro_torch.tree import leaves, tree_map

    cfg = variant_for(get(DENSE_LONG_ARCH).with_(use_flash=True),
                      "long_500k")
    assert cfg.window == cfg.long_context_window == DENSE_LONG_WINDOW
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    api = build(cfg.with_(dtype="float32"))
    n = DENSE_LONG_PROMPT + DENSE_LONG_STEPS
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, n)), device=dev)
    ops.reset_launch_counts()
    with _RingWatch() as ring:
        rec, caches = _f32_against_full(
            api, p32, tokens, DENSE_LONG_PROMPT, DENSE_LONG_STEPS,
            SHAPES["long_500k"]["seq"] + CACHE_MARGIN, "dense long_500k")
    launches = dict(ops.LAUNCH_COUNTS)
    assert not launches, f"windowed attention launched {launches}"
    assert ring.fills == [(DENSE_LONG_PROMPT, cfg.window)] * cfg.n_layers
    want = leaves(input_specs(cfg, "long_500k")["caches"])
    got = leaves(caches)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert rec["cache_bytes"] == DENSE_LONG_CACHE_BYTES_F32, rec
    del p32, caches
    torch.cuda.empty_cache()
    return dict(rec, arch=DENSE_LONG_ARCH, window=cfg.window,
                use_flash=cfg.use_flash, kernel_launches=launches,
                spec_cache_bytes_bf16=sum(w.numel() * w.element_size()
                                          for w in want))


def _long_train(ops, dev) -> dict:
    """The trainer at ``recurrentgemma_9b``'s full width, depth cut to
    one (rglru, rglru, attn) unit: m = 2 learners of 1 x 2,304 tokens a
    round from ``token_stream(seed=0)`` (``_cut_depth_train``), every
    gradient finite and ``Lambda``'s reached."""
    from repro_torch.configs import get
    from repro_torch.data.streams import token_stream

    cfg = get(LONG_ARCH).with_(n_layers=LONG_TRAIN_LAYERS)
    shape = (TRAIN_M, 1, LONG_TRAIN_SEQ)
    batches = [{"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                          device=dev).reshape(shape),
                "labels": torch.as_tensor(labels, dtype=torch.int64,
                                          device=dev).reshape(shape)}
               for toks, labels in token_stream(
                   CUT_TRAIN_T, TRAIN_M, LONG_TRAIN_SEQ, cfg.vocab, seed=0)]
    rec = _cut_depth_train(ops, "hybrid", cfg, batches, dev,
                           LONG_TRAIN_PARAMS, LONG_TRAIN_MODEL_BYTES)
    for r in rec["runs"].values():
        assert r["grad_f32_leaves"] == cfg.pattern.count("rglru"), r
        assert r["grad_max_abs_f32_leaves"] > 0.0, \
            "no gradient reached Lambda"
    rec["reduced"] = {"n_layers": f"{get(LONG_ARCH).n_layers} -> "
                      f"{LONG_TRAIN_LAYERS} (one (rglru, rglru, attn) unit)"}
    return rec


def run_long_phase(ops) -> None:
    """Phase 15 (``lm_long``): ``recurrentgemma_9b`` at full width and
    depth (38 layers, d 4096, bf16 with float32 ``Lambda``; weights drawn
    on the card from seed 0 after phase 14 freed its own):
    ``LMServingEngine`` at batch 4, max_len 4096 (rings of 2048), on
    prompts of 64 to 3,000 tokens (the 3,000-token prefill takes the ring
    path), 32 new tokens; the ``decode_32k`` shape at batch 128; the same
    weights in float32 against a full forward; the dense long-context
    variant; and the trainer at full width, cut depth."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import model_bytes
    from repro_torch.models import build, count_params
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = get(LONG_ARCH)
    dev = device_mod.resolve()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    assert count_params(params) == LONG_PARAMS
    assert model_bytes(params) == LONG_MODEL_BYTES
    line = {"phase": "lm_long", "arch": LONG_ARCH, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "dtype": cfg.dtype, "window": cfg.window,
            "pattern_unit": list(cfg.layer_pattern), "params": LONG_PARAMS}
    with _RingWatch() as ring:
        line["serve"] = _serve_checked(ops, cfg, params, "lm_long serving",
                                       LONG_PROMPTS, LONG_MAX_LEN,
                                       LONG_NEW_TOKENS)
    L = min(LONG_MAX_LEN, cfg.window)
    attn_layers = cfg.pattern.count("attn")
    assert (max(LONG_PROMPTS), L) in ring.fills and \
        len(ring.fills) % attn_layers == 0, ring.fills[:4]
    line["serve"]["ring_fills"] = sorted(set(ring.fills))
    line["decode_32k"] = _long_decode_32k(ops, cfg, params, dev)
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    api = build(cfg.with_(dtype="float32"))
    n = LONG_F32_PROMPT + LONG_F32_STEPS
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, n)), device=dev)
    ops.reset_launch_counts()
    line["f32"], caches = _f32_against_full(
        api, p32, tokens, LONG_F32_PROMPT, LONG_F32_STEPS, n + 8,
        "lm_long")
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    ring_pos = sorted(caches[cfg.pattern.index("attn")].slot_pos.tolist())
    assert ring_pos == list(range(n - L, n)), ring_pos[:3]
    del p32, caches
    torch.cuda.empty_cache()
    line["dense_long_500k"] = _dense_long(ops, dev)
    line["train"] = _long_train(ops, dev)
    torch.cuda.empty_cache()
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit(line)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 16: M-RoPE and the VLM prefix (qwen2_vl_2b)
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2_vl_2b"
VLM_PARAMS = 1_543_910_912        # the reference's tree: param_count's
VLM_MODEL_BYTES = 3_087_821_824   # 1,543,852,032, qkv biases and norms
VLM_TEXT = 300                    # text tokens after the 1,024 embeddings
VLM_DECODE_STEPS = 16
VLM_F32_STEPS = 16
VLM_TRAIN_LAYERS = 4
VLM_TRAIN_SEQ = 256               # text tokens a sequence, after the embeds
VLM_TRAIN_PARAMS = 420_763_136
VLM_TRAIN_MODEL_BYTES = 841_526_272
CUT_TRAIN_T = 4                   # rounds of the cut-depth trainer runs
CUT_TRAIN_PERIOD = 2


def _cut_depth_train(ops, name, cfg, batches, dev, n_params,
                     model_bytes) -> dict:
    """The trainer at full width and cut depth (phases 15 to 17): m =
    ``TRAIN_M`` learners, sgd (lr 0.05, clip 1.0), ``train_periodic``
    (period ``CUT_TRAIN_PERIOD``) and ``train_dynamic`` (delta as phase
    12 picks it) over ``batches``, under phase 12's checks (each run
    repeated bitwise, every gradient finite, the counters held to a host
    recount); no kernel of the port launched; then the rounds timed with
    deterministic algorithms off."""
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.optim import OptimizerConfig

    T = len(batches)
    opt_cfg = OptimizerConfig(kind="sgd", lr=TRAIN_LR, momentum=0.0,
                              grad_clip=1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    periodic = ProtocolConfig(kind="periodic", period=CUT_TRAIN_PERIOD)
    runs = {"train_periodic": _checked_train(
        f"{name} periodic", cfg, periodic, opt_cfg, batches, dev)}
    rec = runs["train_periodic"]
    assert rec["n_params"] == n_params, rec["n_params"]
    assert rec["charge"] == 2 * TRAIN_M * model_bytes, rec["charge"]
    assert sum(rec["flags"]) == T // CUT_TRAIN_PERIOD
    lo = max(rec["dists"][0])
    hi = max(max(d) for d in rec["dists"][:CUT_TRAIN_PERIOD])
    every = [x for d in rec["dists"] for x in d]
    delta = float(np.sqrt(lo * hi))
    assert min(every) < delta < max(every) and lo < delta < hi, (lo, hi)
    dynamic = ProtocolConfig(kind="dynamic", delta=delta, mini_batch=1)
    runs["train_dynamic"] = _checked_train(
        f"{name} dynamic", cfg, dynamic, opt_cfg, batches, dev)
    assert 0 < sum(runs["train_dynamic"]["flags"]) < T, \
        runs["train_dynamic"]["flags"]
    launches = dict(ops.LAUNCH_COUNTS)
    assert not launches, f"the {name} trainer launched {launches}"
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.use_deterministic_algorithms(False)
    try:
        round_ms, wall, state, step = _timed_train_rounds(
            cfg, dynamic, opt_cfg, batches, TRAIN_M, dev)
    finally:
        torch.use_deterministic_algorithms(True)
    del state, step
    tokens = batches[0]["tokens"].numel()
    med = sorted(round_ms[1:])[len(round_ms[1:]) // 2]
    return {
        "m": TRAIN_M, "tokens_per_round": tokens, "T": T,
        "optimizer": dataclasses.asdict(opt_cfg), "dynamic_delta": delta,
        "runs": {key: {
            "protocol": dataclasses.asdict(
                periodic if key == "train_periodic" else dynamic),
            "losses": r["losses"], "sync_rounds": [
                t + 1 for t, f in enumerate(r["flags"]) if f],
            "dists": r["dists"], "bytes_per_sync": r["charge"],
            "grad_max_abs_f32_leaves": r["grad_max_abs_f32_leaves"],
            "grad_f32_leaves": r["grad_f32_leaves"],
            "repeat_bitwise": True} for key, r in runs.items()},
        "params": n_params, "model_bytes": model_bytes,
        "kernel_launches": launches, "max_memory_allocated": peak,
        "round_ms": round_ms, "median_round_ms": med,
        "tokens_per_s": tokens / (med / 1e3), "timed_wall_s": wall}


def _grid_positions(cfg, text: int, dev) -> torch.Tensor:
    """(3, 1, vision_tokens + text) M-RoPE positions: the embeddings as
    a square grid (t 0, h its row, w its column), then the text on three
    equal streams from the grid's side onward."""
    side = int(round(cfg.vision_tokens ** 0.5))
    assert side * side == cfg.vision_tokens
    h, w = torch.meshgrid(torch.arange(side), torch.arange(side),
                          indexing="ij")
    img = torch.stack([torch.zeros(side * side, dtype=torch.int64),
                       h.reshape(-1), w.reshape(-1)])
    txt = torch.arange(side, side + text).expand(3, text)
    return torch.cat([img, txt], dim=1)[:, None].to(dev)


def _vlm_inputs(cfg, B: int, text: int, dev, seed: int = 0) -> dict:
    """``B`` samples of ``vision_tokens`` seeded patch embeddings (float32
    normals, cast to the model's dtype inside) and ``text`` tokens."""
    rng = np.random.default_rng(seed)
    embeds = rng.normal(size=(B, cfg.vision_tokens, cfg.d_model))
    return {"embeds": torch.as_tensor(embeds.astype(np.float32),
                                      device=dev),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, text)),
                                      device=dev)}


def _vlm_generate(api, params, batch) -> tuple:
    """``LMServingEngine.run``'s loop on one batch, at the model API (the
    engine takes no ``embeds``): the prefill of embeddings and tokens,
    then ``VLM_DECODE_STEPS`` greedy decode steps at positions
    vision_tokens + S_text onward, each step's tokens read back as the
    engine reads them.  Returns (tokens a step, the logits a step)."""
    cfg = api.cfg
    S = cfg.vision_tokens + batch["tokens"].shape[1]
    caches = api.init_caches(batch["tokens"].shape[0], S + VLM_DECODE_STEPS)
    toks, lgs = [], []
    with torch.no_grad():
        logits, caches = api.prefill(params, batch, caches)
        for step in range(VLM_DECODE_STEPS + 1):
            lg = logits[:, -1, :cfg.vocab]
            nxt = torch.argmax(lg, dim=-1)[:, None]
            toks.append(nxt[:, 0].tolist())
            lgs.append(lg)
            if step < VLM_DECODE_STEPS:
                logits, caches = api.decode(params, caches, nxt, S + step)
    return toks, torch.stack(lgs)


def _vlm_serve(ops, totals, cfg, params, dev) -> dict:
    """Phase 16's serving run at batch 4 (see ``run_vlm_phase``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build

    api = build(cfg)
    batch = _vlm_inputs(cfg, LM_BATCH, VLM_TEXT, dev)
    S = cfg.vision_tokens + VLM_TEXT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _FlashAgainstPlain() as layers:
        toks, logits = _vlm_generate(api, params, batch)
    counts = dict(ops.LAUNCH_COUNTS)
    assert counts == {"flash": cfg.n_layers}, counts
    assert layers.calls == cfg.n_layers and layers.seqs == {S}, \
        (layers.calls, layers.seqs)
    totals["flash"] = totals.get("flash", 0) + counts["flash"]
    assert all(0 <= t < cfg.vocab for row in toks for t in row)
    again, again_logits = _vlm_generate(api, params, batch)
    assert again == toks and torch.equal(again_logits, logits), \
        "lm_vlm: a repeat differs"
    peak = torch.cuda.max_memory_allocated()
    del again_logits
    torch.use_deterministic_algorithms(False)
    try:
        holder = types.SimpleNamespace(api=api)
        clock = _StepClock(holder)
        t0 = time.perf_counter()
        served, _ = _vlm_generate(holder.api, params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _vlm_generate(api, params, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(True)
    steps = _steps(prof)
    dec = [x for x in steps if not x["flash"]]
    generated = LM_BATCH * len(toks)
    prefill_s, decode_s = clock.seconds("prefill"), clock.seconds("decode")
    return {"batch": LM_BATCH, "vision_tokens": cfg.vision_tokens,
            "text_tokens": VLM_TEXT, "prefill_len": S,
            "decode_steps": VLM_DECODE_STEPS, "decode_positions": [
                S, S + VLM_DECODE_STEPS - 1],
            "kernel_launches": counts, "max_memory_allocated": peak,
            "repeat_bitwise": True, "generated_tokens": generated,
            "wall_s": secs, "tokens_per_wall_s": generated / secs,
            "same_tokens": served == toks, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_ms_per_step": decode_s * 1e3 / VLM_DECODE_STEPS,
            "steps_traced": len(steps),
            "decode_kernels_per_step": sorted(x["kernels"] for x in dec),
            "decode_device_ms_per_step_median": sorted(
                x["device_s"] * 1e3 for x in dec)[len(dec) // 2]
            if dec else None,
            "flash_layers_checked": layers.calls,
            "flash_layer_max_abs_err": layers.max_err,
            "flash_layer_max_ulps": layers.max_ulps,
            "flash_layer_outputs_differing": layers.differ,
            "flash_layer_outputs": layers.of}


def _vlm_layer_against_cpu(ops, cfg, params, dev) -> dict:
    """One full-width layer's ``gqa_forward`` (flash) with distinct
    M-RoPE streams, positions (3, 1, 1,324), in float32 on the card
    against the same call on the CPU, within the parity pair."""
    from repro_torch.models import attention
    from repro_torch.tree import tree_map

    cfg32 = cfg.with_(dtype="float32")
    S = cfg.vision_tokens + VLM_TEXT
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(1, S, cfg.d_model)).astype(np.float32))
    pos = _grid_positions(cfg, VLM_TEXT, "cpu")
    p = tree_map(lambda t: t.float(), params["layers"][0]["attn"])
    ops.reset_launch_counts()
    with torch.no_grad():
        got = attention.gqa_forward(cfg32, p, x.to(dev), pos.to(dev))
        counts = dict(ops.LAUNCH_COUNTS)
        want = attention.gqa_forward(cfg32, tree_map(lambda t: t.cpu(), p),
                                     x, pos)
    assert counts == {"flash": 1}, counts
    err = close(got.cpu(), want, "lm_vlm: the layer on the card vs the CPU")
    return {"positions": list(pos.shape), "streams_differ": bool(
        (pos[0] != pos[1]).any()), "max_abs_err": err,
        "kernel_launches": counts}


def _vlm_train(ops, dev) -> dict:
    """The trainer at ``qwen2_vl_2b``'s full width cut to
    ``VLM_TRAIN_LAYERS`` layers (``use_flash=False``: the trainer's
    attention is the plain one), m = 2 learners of 1 x (1,024 embeddings
    + 256 tokens) a round: tokens from ``token_stream(seed=0)``, the
    embeddings seeded normals (``_cut_depth_train``)."""
    from repro_torch.configs import get
    from repro_torch.data.streams import token_stream

    cfg = get(VLM_ARCH).with_(n_layers=VLM_TRAIN_LAYERS, use_flash=False)
    shape = (TRAIN_M, 1, VLM_TRAIN_SEQ)
    rng = np.random.default_rng(0)
    batches = []
    for toks, labels in token_stream(CUT_TRAIN_T, TRAIN_M, VLM_TRAIN_SEQ,
                                     cfg.vocab, seed=0):
        emb = rng.normal(size=(TRAIN_M, 1, cfg.vision_tokens, cfg.d_model))
        batches.append({
            "tokens": torch.as_tensor(toks, dtype=torch.int64,
                                      device=dev).reshape(shape),
            "labels": torch.as_tensor(labels, dtype=torch.int64,
                                      device=dev).reshape(shape),
            "embeds": torch.as_tensor(emb.astype(np.float32), device=dev)})
    rec = _cut_depth_train(ops, "lm_vlm", cfg, batches, dev,
                           VLM_TRAIN_PARAMS, VLM_TRAIN_MODEL_BYTES)
    rec["reduced"] = {"n_layers": f"{get(VLM_ARCH).n_layers} -> "
                                  f"{VLM_TRAIN_LAYERS}"}
    rec["embeds_per_sequence"] = cfg.vision_tokens
    return rec


def run_vlm_phase(ops, totals, flashmod, ref) -> dict:
    """Phase 16 (``lm_vlm``): ``qwen2_vl_2b`` at full width and depth (28
    layers, d 1536, 12 heads over 2 kv heads of 128, M-RoPE sections
    (16, 24, 24), bf16, ``use_flash=True``; weights drawn on the card
    from seed 0): served at batch 4, each sample 1,024 patch embeddings
    and 300 tokens, with 16 greedy decode steps (``_vlm_serve``);
    ``flash`` timed at that prefill's shape; one layer with distinct
    streams against the CPU; the same weights in float32 against a full
    forward; the trainer at 4 layers.  Returns the ``flash`` kernels
    line's ``lm_vlm_shapes``."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import model_bytes
    from repro_torch.models import build, count_params
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = get(VLM_ARCH).with_(use_flash=True)
    dev = device_mod.resolve()
    torch.cuda.empty_cache()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    assert count_params(params) == VLM_PARAMS
    assert model_bytes(params) == VLM_MODEL_BYTES
    line = {"phase": "lm_vlm", "arch": VLM_ARCH, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "hd": cfg.hd, "mrope_sections": list(cfg.mrope_sections),
            "dtype": cfg.dtype, "params": VLM_PARAMS,
            "serve": _vlm_serve(ops, totals, cfg, params, dev)}
    S = cfg.vision_tokens + VLM_TEXT
    BH = LM_BATCH * cfg.n_heads
    ms, plain, library, (bms, by), gemm, _ = flash_timing(
        flashmod, ref, BH, S, cfg.hd, LM_BATCH, dev,
        torch.Generator().manual_seed(0))
    shapes = {VLM_ARCH: {
        "shape": [BH, S, cfg.hd], "launches": cfg.n_layers,
        "ms": ms["ms"], "device_ms": ms["device_ms"],
        "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
        "library_ms": library["ms"],
        "library_device_ms": library["device_ms"],
        "bound_ms": bms, "bound_by": by,
        "attention_tflops": gemm * 2 / ms["device_ms"] / 1e9}}
    line["flash"] = shapes[VLM_ARCH]
    line["layer_vs_cpu"] = _vlm_layer_against_cpu(ops, cfg, params, dev)
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    api = build(cfg.with_(dtype="float32"))
    inputs = _vlm_inputs(cfg, 1, VLM_TEXT + VLM_F32_STEPS, dev, seed=2)
    ops.reset_launch_counts()
    line["f32"], caches = _f32_against_full(
        api, p32, inputs["tokens"], VLM_TEXT, VLM_F32_STEPS,
        S + VLM_F32_STEPS + 8, "lm_vlm", embeds=inputs["embeds"])
    line["f32"]["flash_launches"] = dict(ops.LAUNCH_COUNTS)
    del p32, caches
    torch.cuda.empty_cache()
    line["train"] = _vlm_train(ops, dev)
    torch.cuda.empty_cache()
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit(line)
    return shapes


# ---------------------------------------------------------------------------
# Phase 17: multi-head latent attention (minicpm3_4b)
# ---------------------------------------------------------------------------

MLA_ARCH = "minicpm3_4b"
MLA_PARAMS = 4_073_937_408        # the reference's tree: param_count's
MLA_MODEL_BYTES = 8_147_874_816   # 4,073,871,360 and the norm scales
MLA_PROMPTS = (1024, 700, 333, 64)
MLA_NEW_TOKENS = 32
MLA_F32_PROMPT = 1024
MLA_F32_STEPS = 16
MLA_TRAIN_LAYERS = 3
MLA_TRAIN_SEQ = 1024
MLA_TRAIN_PARAMS = 376_115_712
MLA_TRAIN_MODEL_BYTES = 752_231_424
MLA_CACHE_BYTES_PER_TOKEN = 576   # a layer: (kv_lora 256 + rope 32) x bf16
NAIVE_RTOL, NAIVE_ATOL = 1e-4, 1e-5   # tests/test_attention.py:76


class _NaiveWatch:
    """While active, the first ``limit`` ``mla_decode`` calls (one decode
    step of every layer) also run the naive form on a copy of the cache;
    the absorbed output must be within rtol 1e-4, atol 1e-5 of it
    (tests/test_attention.py:58)."""

    def __init__(self, limit: int):
        from repro_torch.models import attention
        self.mod, self.orig = attention, attention.mla_decode
        self.limit, self.calls, self.max_err = limit, 0, 0.0

    def __enter__(self):
        self.mod.mla_decode = self._checked
        return self

    def __exit__(self, *exc):
        self.mod.mla_decode = self.orig

    def _checked(self, cfg, p, x_t, pos, cache, **kw):
        if self.calls >= self.limit:
            return self.orig(cfg, p, x_t, pos, cache, **kw)
        copy = self.mod.MLACache(*(t.clone() for t in cache))
        naive, _ = self.orig(cfg, p, x_t, pos, copy,
                             **dict(kw, absorbed=False))
        out, cache = self.orig(cfg, p, x_t, pos, cache, **kw)
        gap = (out - naive).abs()
        assert bool((gap <= NAIVE_ATOL + NAIVE_RTOL * naive.abs()).all()), \
            f"lm_mla: absorbed decode {float(gap.max())} off the naive one"
        self.calls += 1
        self.max_err = max(self.max_err, float(gap.max()))
        return out, cache


def _mla_train(ops, dev) -> dict:
    """The trainer at ``minicpm3_4b``'s full width cut to
    ``MLA_TRAIN_LAYERS`` layers, m = 2 learners of 1 x 1,024 tokens a
    round from ``token_stream(seed=0)`` (``_cut_depth_train``)."""
    from repro_torch.configs import get
    from repro_torch.data.streams import token_stream

    cfg = get(MLA_ARCH).with_(n_layers=MLA_TRAIN_LAYERS)
    shape = (TRAIN_M, 1, MLA_TRAIN_SEQ)
    batches = [{"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                          device=dev).reshape(shape),
                "labels": torch.as_tensor(labels, dtype=torch.int64,
                                          device=dev).reshape(shape)}
               for toks, labels in token_stream(
                   CUT_TRAIN_T, TRAIN_M, MLA_TRAIN_SEQ, cfg.vocab, seed=0)]
    rec = _cut_depth_train(ops, "lm_mla", cfg, batches, dev,
                           MLA_TRAIN_PARAMS, MLA_TRAIN_MODEL_BYTES)
    rec["reduced"] = {"n_layers": f"{get(MLA_ARCH).n_layers} -> "
                                  f"{MLA_TRAIN_LAYERS}"}
    return rec


def run_mla_phase(ops) -> None:
    """Phase 17 (``lm_mla``): ``minicpm3_4b`` at full width and depth (62
    layers, d 2560, 40 heads, q_lora 768, kv_lora 256, nope 64, rope 32,
    v 64, bf16; weights drawn on the card from seed 0 after phase 16
    freed its own): ``LMServingEngine`` at batch 4 on ``MLA_PROMPTS``,
    32 new tokens (``_serve_checked``: a repeat bitwise, no kernel of
    the port launched); the latent cache's bytes a token; the same
    weights in float32, a 1,024-token prefill and 16 teacher-forced
    decode steps against a full forward, the first step's absorbed
    decode against the naive one in every layer; the trainer at 3
    layers."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import model_bytes
    from repro_torch.models import build, count_params
    from repro_torch.tree import leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get(MLA_ARCH)
    dev = device_mod.resolve()
    torch.cuda.empty_cache()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    assert count_params(params) == MLA_PARAMS
    assert model_bytes(params) == MLA_MODEL_BYTES
    line = {"phase": "lm_mla", "arch": MLA_ARCH, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads,
            "mla": {k: getattr(cfg, f"mla_{k}") for k in (
                "q_lora", "kv_lora", "nope_dim", "rope_dim", "v_dim")},
            "dtype": cfg.dtype, "params": MLA_PARAMS}
    line["serve"] = _serve_checked(
        ops, cfg, params, "lm_mla serving", MLA_PROMPTS,
        max(MLA_PROMPTS) + MLA_NEW_TOKENS, MLA_NEW_TOKENS)
    one = build(cfg).init_caches(1, 1)[0]
    per_token = sum(t.numel() * t.element_size() for t in (one.c,
                                                             one.k_rope))
    assert per_token == (cfg.mla_kv_lora + cfg.mla_rope_dim) * 2 \
        == MLA_CACHE_BYTES_PER_TOKEN, per_token
    line["cache_bytes_per_token_layer"] = per_token
    line["gqa_cache_bytes_per_token_layer"] = cfg.n_heads * (
        cfg.mla_nope_dim + cfg.mla_rope_dim + cfg.mla_v_dim) * 2
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    api = build(cfg.with_(dtype="float32"))
    n = MLA_F32_PROMPT + MLA_F32_STEPS
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, n)), device=dev)
    ops.reset_launch_counts()
    with _NaiveWatch(cfg.n_layers) as naive:
        line["f32"], caches = _f32_against_full(
            api, p32, tokens, MLA_F32_PROMPT, MLA_F32_STEPS, n + 8,
            "lm_mla")
    assert naive.calls == cfg.n_layers, naive.calls
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    assert all(type(c).__name__ == "MLACache" for c in caches)
    line["f32"].update(absorbed_vs_naive_layers=naive.calls,
                       absorbed_vs_naive_max_abs_err=naive.max_err,
                       absorbed_vs_naive_tol=[NAIVE_RTOL, NAIVE_ATOL],
                       cache_leaves=len(leaves(caches)))
    del p32, caches
    torch.cuda.empty_cache()
    line["train"] = _mla_train(ops, dev)
    torch.cuda.empty_cache()
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit(line)

# ---------------------------------------------------------------------------
# Phase 18: the MoE family (olmoe_1b_7b, granite_moe_1b_a400m)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("olmoe_1b_7b", "granite_moe_1b_a400m")
MOE_PARAMS = {"olmoe_1b_7b": 6_919_624_704,           # the reference's trees:
              "granite_moe_1b_a400m": 1_334_887_424}  # param_count's and the
MOE_MODEL_BYTES = {"olmoe_1b_7b": 13_839_249_408,     # norm scales
                   "granite_moe_1b_a400m": 2_669_774_848}
MOE_PROMPTS = (1024, 700, 333, 64)
MOE_NEW_TOKENS = 32
MOE_F32_PROMPT = 512
MOE_F32_STEPS = 16
MOE_F32_LAYERS = {"olmoe_1b_7b": 4, "granite_moe_1b_a400m": 24}
MOE_TRAIN_ARCH = "olmoe_1b_7b"
MOE_TRAIN_LAYERS = 3
MOE_TRAIN_SEQ = 512
MOE_TRAIN_PARAMS = 1_465_268_992
MOE_TRAIN_MODEL_BYTES = 2_930_537_984


class _DropWatch:
    """While active, records each grouped MoE call's routing
    (``moe.route_grouped``): its real tokens, their T K assignments and
    how many were kept (the padded rows' are not counted)."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.orig = moe, moe.route_grouped
        self.calls = []

    def __enter__(self):
        self.mod.route_grouped = self._record
        return self

    def __exit__(self, *exc):
        self.mod.route_grouped = self.orig

    def _record(self, cfg, p, xt, T):
        out = self.orig(cfg, p, xt, T)
        keep = out[5].reshape(-1, cfg.top_k)[:T]
        self.calls.append((T, T * cfg.top_k, int(keep.sum())))
        return out

    def summary(self) -> dict:
        return {"grouped_calls": len(self.calls),
                "tokens": sum(c[0] for c in self.calls),
                "assignments": sum(c[1] for c in self.calls),
                "dropped": sum(c[1] - c[2] for c in self.calls),
                "dropped_by_call": [c[1] - c[2] for c in self.calls]}


def _moe_f32(ops, arch, cfg, params, dev) -> dict:
    """The weights in float32 at ``MOE_F32_LAYERS[arch]`` layers with
    ``capacity_factor = E / K`` (C_g = G: no assignment can drop, so the
    routed prefill, the dense decode and the full forward compute one
    function): a ``MOE_F32_PROMPT``-token prefill and ``MOE_F32_STEPS``
    teacher-forced decode steps against a full forward
    (``_f32_against_full``), every grouped call keeping all T K of its
    assignments."""
    from repro_torch.models import build
    from repro_torch.tree import tree_map

    n = MOE_F32_LAYERS[arch]
    factor = cfg.n_experts / cfg.top_k
    cfg32 = cfg.with_(dtype="float32", n_layers=n, capacity_factor=factor)
    p32 = tree_map(lambda x: x.float(),
                   dict(params, layers=params["layers"][:n]))
    total = MOE_F32_PROMPT + MOE_F32_STEPS
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, total)), device=dev)
    ops.reset_launch_counts()
    with _DropWatch() as drops:
        rec, caches = _f32_against_full(build(cfg32), p32, tokens,
                                        MOE_F32_PROMPT, MOE_F32_STEPS,
                                        total + 8, f"lm_moe {arch}")
    kept = drops.summary()
    assert kept["grouped_calls"] == 2 * n and kept["dropped"] == 0, kept
    del p32, caches
    rec.update(layers=n, capacity_factor=factor,
               flash_launches=dict(ops.LAUNCH_COUNTS),
               grouped_calls=kept["grouped_calls"],
               assignments=kept["assignments"], kept=kept["assignments"])
    return rec


def _moe_train(ops, dev) -> dict:
    """The trainer at ``olmoe_1b_7b``'s full width cut to
    ``MOE_TRAIN_LAYERS`` layers, m = 2 learners of 1 x 512 tokens a round
    from ``token_stream(seed=0)`` (``_cut_depth_train``); the loss
    carries the aux loss, nonzero on the first batch from seed 0."""
    from repro_torch.configs import get
    from repro_torch.data.streams import token_stream
    from repro_torch.models import build

    cfg = get(MOE_TRAIN_ARCH).with_(n_layers=MOE_TRAIN_LAYERS)
    shape = (TRAIN_M, 1, MOE_TRAIN_SEQ)
    batches = [{"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                          device=dev).reshape(shape),
                "labels": torch.as_tensor(labels, dtype=torch.int64,
                                          device=dev).reshape(shape)}
               for toks, labels in token_stream(
                   CUT_TRAIN_T, TRAIN_M, MOE_TRAIN_SEQ, cfg.vocab, seed=0)]
    api = build(cfg)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        _, aux = api.forward(params, {"tokens": batches[0]["tokens"][0]})
    aux = float(aux)
    assert np.isfinite(aux) and aux > 0, aux
    del params
    torch.cuda.empty_cache()
    rec = _cut_depth_train(ops, "lm_moe", cfg, batches, dev,
                           MOE_TRAIN_PARAMS, MOE_TRAIN_MODEL_BYTES)
    rec["reduced"] = {"n_layers": f"{get(MOE_TRAIN_ARCH).n_layers} -> "
                                  f"{MOE_TRAIN_LAYERS}"}
    rec["aux_loss_round_1"] = aux
    return rec


def run_moe_phase(ops, totals, flashmod, ref) -> dict:
    """Phase 18 (``lm_moe``): ``olmoe_1b_7b`` (16 layers, d 2048, 16
    heads of 128, ``qk_norm``, 64 experts, top 8) and then
    ``granite_moe_1b_a400m`` (24 layers, d 1024, 16 heads over 8 kv heads
    of 64, 32 experts, top 8, tied embeddings), bf16, ``use_flash=True``,
    full width and depth from seed 0, one at a time: ``LMServingEngine``
    at batch 4 on ``MOE_PROMPTS``, 32 new tokens, under
    ``_serve_checked`` with every flash layer held to the plain attention
    on its own q, k, v and each prefill layer's dropped assignments
    counted (capacity factor 1.25); ``flash`` timed at the prefill's
    shape; the float32 decode against a full forward (``_moe_f32``);
    ``olmoe_1b_7b``'s trainer at 3 layers.  Returns the ``flash`` kernels
    line's ``lm_moe_shapes``."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import model_bytes
    from repro_torch.models import build, count_params

    dev = device_mod.resolve()
    shapes = {}
    for arch in MOE_ARCHS:
        t_arch = time.perf_counter()
        cfg = get(arch).with_(use_flash=True)
        torch.cuda.empty_cache()
        params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
        assert count_params(params) == MOE_PARAMS[arch]
        assert model_bytes(params) == MOE_MODEL_BYTES[arch]
        line = {"phase": "lm_moe", "arch": arch, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model,
                "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.hd,
                "experts": [cfg.n_experts, cfg.top_k, cfg.expert_ff],
                "capacity_factor": cfg.capacity_factor,
                "moe_group_size": cfg.moe_group_size, "dtype": cfg.dtype,
                "params": MOE_PARAMS[arch]}
        flash_layers, drops = _FlashAgainstPlain(), _DropWatch()

        @contextlib.contextmanager
        def watch():
            with flash_layers, drops:
                yield

        line["serve"] = _serve_checked(
            ops, cfg, params, f"lm_moe {arch} serving", MOE_PROMPTS,
            max(MOE_PROMPTS) + MOE_NEW_TOKENS, MOE_NEW_TOKENS,
            expect={"flash": cfg.n_layers}, watch=watch)
        assert flash_layers.calls == cfg.n_layers, flash_layers.calls
        assert flash_layers.seqs == {max(MOE_PROMPTS)}, flash_layers.seqs
        totals["flash"] = totals.get("flash", 0) + cfg.n_layers
        routed = drops.summary()
        assert routed["grouped_calls"] == cfg.n_layers, routed
        assert routed["tokens"] == cfg.n_layers * LM_BATCH * max(MOE_PROMPTS)
        line["serve"].update(
            flash_layers_checked=flash_layers.calls,
            flash_layer_max_abs_err=flash_layers.max_err,
            flash_layer_max_ulps=flash_layers.max_ulps,
            flash_layer_outputs_differing=flash_layers.differ,
            flash_layer_outputs=flash_layers.of,
            prefill_assignments=routed["assignments"],
            prefill_dropped=routed["dropped"],
            prefill_dropped_by_layer=routed["dropped_by_call"])
        BH = LM_BATCH * cfg.n_heads
        ms, plain, library, (bms, by), gemm, _ = flash_timing(
            flashmod, ref, BH, max(MOE_PROMPTS), cfg.hd, LM_BATCH, dev,
            torch.Generator().manual_seed(0))
        shapes[arch] = {
            "shape": [BH, max(MOE_PROMPTS), cfg.hd],
            "launches": cfg.n_layers, "ms": ms["ms"],
            "device_ms": ms["device_ms"], "plain_ms": plain["ms"],
            "plain_device_ms": plain["device_ms"],
            "library_ms": library["ms"],
            "library_device_ms": library["device_ms"],
            "bound_ms": bms, "bound_by": by,
            "attention_tflops": gemm * 2 / ms["device_ms"] / 1e9}
        line["flash"] = shapes[arch]
        line["f32"] = _moe_f32(ops, arch, cfg, params, dev)
        del params
        torch.cuda.empty_cache()
        if arch == MOE_TRAIN_ARCH:
            line["train"] = _moe_train(ops, dev)
            torch.cuda.empty_cache()
        line["arch_wall_s"] = time.perf_counter() - t_arch
        emit(line)
    return shapes


# ---------------------------------------------------------------------------
# Phase 19: the encoder-decoder (whisper_large_v3)
# ---------------------------------------------------------------------------

AUDIO_ARCH = "whisper_large_v3"
AUDIO_PARAMS = 1_545_835_520      # the reference's tree: param_count's
AUDIO_MODEL_BYTES = 3_091_671_040  # 1,534,607,360, the position table, biases
AUDIO_PROMPT = 4                  # decoder prompt tokens a sample
AUDIO_NEW_TOKENS = 32
AUDIO_MAX_LEN = 448               # Whisper's decoder context
AUDIO_F32_STEPS = 31
AUDIO_TRAIN_LAYERS = 4            # encoder and decoder layers each
AUDIO_TRAIN_SEQ = 256
AUDIO_TRAIN_PARAMS = 260_613_120
AUDIO_TRAIN_MODEL_BYTES = 521_226_240


def _audio_inputs(cfg, B: int, S: int, dev, seed: int = 0) -> dict:
    """``B`` samples of ``n_audio_frames`` seeded frame embeddings (float32
    normals, the reference's stub frontend; cast to the model's dtype
    inside) and ``S`` decoder tokens."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, cfg.n_audio_frames, cfg.d_model))
    return {"frames": torch.as_tensor(frames.astype(np.float32),
                                      device=dev),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)),
                                      device=dev)}


def _audio_generate(api, params, batch) -> tuple:
    """``launch/serve.py``'s steps on one batch: ``make_prefill_step``
    (the encoder, the decoder prompt, the caches of ``AUDIO_MAX_LEN``
    slots), then ``AUDIO_NEW_TOKENS - 1`` greedy ``make_decode_step``
    calls, each step's tokens read back as an engine reads them.
    ``api.prefill`` / ``api.decode`` are the two steps.  Returns (tokens
    a step, the prefill's logits)."""
    cfg = api.cfg
    B, S = batch["tokens"].shape
    caches = api.init_caches(B, AUDIO_MAX_LEN)
    with torch.no_grad():
        logits, caches = api.prefill(params, batch, caches)
        nxt = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(
            torch.int32)
        toks = [nxt[:, 0].tolist()]
        for step in range(AUDIO_NEW_TOKENS - 1):
            nxt, caches = api.decode(params, caches, nxt, S + step)
            toks.append(nxt[:, 0].tolist())
    return toks, logits


def _audio_serve(ops, cfg, params, dev) -> dict:
    """Phase 19's serving run at batch 4 (see ``run_audio_phase``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import build

    api = dataclasses.replace(build(cfg), prefill=make_prefill_step(cfg),
                              decode=make_decode_step(cfg))
    batch = _audio_inputs(cfg, LM_BATCH, AUDIO_PROMPT, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, logits = _audio_generate(api, params, batch)
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    assert all(0 <= t < cfg.vocab for row in toks for t in row)
    again, again_logits = _audio_generate(api, params, batch)
    assert again == toks and torch.equal(again_logits, logits), \
        "lm_audio: a repeat differs"
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    del again_logits, logits
    torch.use_deterministic_algorithms(False)
    try:
        holder = types.SimpleNamespace(api=api)
        clock = _StepClock(holder)
        t0 = time.perf_counter()
        served, _ = _audio_generate(holder.api, params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _audio_generate(api, params, batch)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(True)
    steps = _steps(prof)
    dec = sorted(steps, key=lambda x: x["kernels"])[:-1]
    generated = LM_BATCH * len(toks)
    prefill_s, decode_s = clock.seconds("prefill"), clock.seconds("decode")
    return {"batch": LM_BATCH, "frames": cfg.n_audio_frames,
            "prompt_tokens": AUDIO_PROMPT, "new_tokens": AUDIO_NEW_TOKENS,
            "max_len": AUDIO_MAX_LEN, "kernel_launches": {},
            "max_memory_allocated": peak, "repeat_bitwise": True,
            "generated_tokens": generated, "wall_s": secs,
            "tokens_per_wall_s": generated / secs,
            "same_tokens": served == toks, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_ms_per_step": decode_s * 1e3 / (AUDIO_NEW_TOKENS - 1),
            "steps_traced": len(steps),
            "decode_kernels_per_step_median": sorted(
                x["kernels"] for x in dec)[len(dec) // 2] if dec else None,
            "decode_device_ms_per_step_median": sorted(
                x["device_s"] * 1e3 for x in dec)[len(dec) // 2]
            if dec else None}


def _audio_layer_against_cpu(ops, cfg, params, dev) -> dict:
    """The first encoder layer at full width in float32 over 1,500 seeded
    frames (the sinusoidal positions, the layer, the final norm:
    ``encode`` at one layer) on the card against the CPU, within the
    parity pair."""
    from repro_torch.models import encdec
    from repro_torch.tree import tree_map

    cfg1 = cfg.with_(encoder_layers=1, n_layers=1, dtype="float32")
    p = tree_map(lambda t: t.float(), {
        "enc_blocks": params["enc_blocks"][:1],
        "enc_norm": params["enc_norm"]})
    frames = torch.as_tensor(np.random.default_rng(1).normal(
        size=(1, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = encdec.encode(p, cfg1, frames.to(dev))
        want = encdec.encode(tree_map(lambda t: t.cpu(), p), cfg1, frames)
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    err = close(got.cpu(), want,
                "lm_audio: the encoder layer on the card vs the CPU")
    return {"frames": cfg.n_audio_frames, "max_abs_err": err}


def _audio_train(ops, dev) -> dict:
    """The trainer at ``whisper_large_v3``'s full width cut to 4 encoder
    and 4 decoder layers, m = 2 learners of 1 x (1,500 frames + 256
    tokens) a round: tokens from ``token_stream(seed=0)``, the frames
    seeded normals (``_cut_depth_train``)."""
    from repro_torch.configs import get
    from repro_torch.data.streams import token_stream

    cfg = get(AUDIO_ARCH).with_(n_layers=AUDIO_TRAIN_LAYERS,
                                encoder_layers=AUDIO_TRAIN_LAYERS)
    shape = (TRAIN_M, 1, AUDIO_TRAIN_SEQ)
    rng = np.random.default_rng(0)
    batches = []
    for toks, labels in token_stream(CUT_TRAIN_T, TRAIN_M, AUDIO_TRAIN_SEQ,
                                     cfg.vocab, seed=0):
        fr = rng.normal(size=(TRAIN_M, 1, cfg.n_audio_frames, cfg.d_model))
        batches.append({
            "tokens": torch.as_tensor(toks, dtype=torch.int64,
                                      device=dev).reshape(shape),
            "labels": torch.as_tensor(labels, dtype=torch.int64,
                                      device=dev).reshape(shape),
            "frames": torch.as_tensor(fr.astype(np.float32), device=dev)})
    rec = _cut_depth_train(ops, "lm_audio", cfg, batches, dev,
                           AUDIO_TRAIN_PARAMS, AUDIO_TRAIN_MODEL_BYTES)
    full = get(AUDIO_ARCH)
    rec["reduced"] = {
        "n_layers": f"{full.n_layers} -> {AUDIO_TRAIN_LAYERS}",
        "encoder_layers": f"{full.encoder_layers} -> {AUDIO_TRAIN_LAYERS}"}
    rec["frames_per_sequence"] = cfg.n_audio_frames
    return rec


def run_audio_phase(ops) -> None:
    """Phase 19 (``lm_audio``): ``whisper_large_v3`` at full width and
    depth (32 encoder and 32 decoder layers, d 1280, 20 heads of 64,
    LayerNorm, GELU, learned decoder positions, tied embeddings, bf16,
    ``use_flash=False``, the config's: the reference refuses its
    non-causal flash at 1,500 frames; weights drawn on the card from seed
    0): at batch 4 of 1,500 seeded frame embeddings and 4 decoder
    tokens, ``make_prefill_step`` and 31 greedy ``make_decode_step``
    calls with caches of 448 slots, no kernel of the port launched, a
    repeat bitwise, then timed with deterministic algorithms off
    (``_audio_serve``); one encoder layer on the card against the CPU;
    the same weights in float32, a 4-token prefill and 31 teacher-forced
    decode steps against ``decode_train``; the trainer at 4 + 4
    layers."""
    from repro_torch import device as device_mod
    from repro_torch.configs import get
    from repro_torch.core.protocol import model_bytes
    from repro_torch.models import build, count_params
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    cfg = get(AUDIO_ARCH)
    assert not cfg.use_flash
    dev = device_mod.resolve()
    torch.cuda.empty_cache()
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0))
    assert count_params(params) == AUDIO_PARAMS
    assert model_bytes(params) == AUDIO_MODEL_BYTES
    line = {"phase": "lm_audio", "arch": AUDIO_ARCH,
            "layers": [cfg.encoder_layers, cfg.n_layers],
            "d_model": cfg.d_model, "heads": cfg.n_heads, "hd": cfg.hd,
            "dtype": cfg.dtype, "params": AUDIO_PARAMS,
            "serve": _audio_serve(ops, cfg, params, dev),
            "layer_vs_cpu": _audio_layer_against_cpu(ops, cfg, params, dev)}
    p32 = tree_map(lambda x: x.float(), params)
    del params
    torch.cuda.empty_cache()
    inputs = _audio_inputs(cfg, 1, AUDIO_PROMPT + AUDIO_F32_STEPS, dev,
                           seed=2)
    ops.reset_launch_counts()
    line["f32"], caches = _f32_against_full(
        build(cfg.with_(dtype="float32")), p32, inputs["tokens"],
        AUDIO_PROMPT, AUDIO_F32_STEPS, AUDIO_MAX_LEN, "lm_audio",
        frames=inputs["frames"])
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    del p32, caches
    torch.cuda.empty_cache()
    line["train"] = _audio_train(ops, dev)
    torch.cuda.empty_cache()
    line["phase_wall_s"] = time.perf_counter() - t_phase
    emit(line)



# ---------------------------------------------------------------------------
# Phase 20: the dry run on meta tensors, two decode steps held on the card
# ---------------------------------------------------------------------------

#: one architecture per family (``arch_type``): the full ``--all`` of 40
#: combos took 107 s in one process on a CPU, over the phase's 90 s
LAUNCH_ARCHS = ("qwen2_5_3b", "olmoe_1b_7b", "mamba2_130m",
                "recurrentgemma_9b", "qwen2_vl_2b", "whisper_large_v3")
LAUNCH_CARD_ARCHS = ("qwen2_5_3b", "mamba2_130m")
LAUNCH_SHAPE = "long_500k"
LAUNCH_WARMUP = 3
LAUNCH_ITERS = 20
LAUNCH_BUSY_STEPS = 5


def _median_event_ms(fn, warmup: int, iters: int) -> float:
    """The median of ``iters`` calls' CUDA-event times, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _launch_busy(run, steps: int) -> dict:
    """Where a decode step's time goes: ``steps`` calls of ``run`` once
    unprofiled for their wall time and once profiled for their CUDA
    activities (kernels, copies, sets), as ``_busy_window`` reads a run
    phase.  Per step: the wall and device ms, the activities, the three
    activities of most device time; and the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    def steps_of_run():
        for _ in range(steps):
            run()
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps_of_run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps_of_run()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    by_name: collections.Counter = collections.Counter()
    for e in evs:
        by_name[e.name()[:60]] += e.duration_ns() / 1e6 / steps
    device_ms = sum(by_name.values())
    return {"busy_steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_ms_per_step": device_ms,
            "activities_per_step": len(evs) / steps,
            "device_busy_share": device_ms * steps / (wall * 1e3),
            "top_device_ms_per_step": dict(by_name.most_common(3))}


def _launch_card_step(arch: str, rec: dict, dev) -> dict:
    """The dry run's decode record of ``arch`` held to one step on the
    card (see the module docstring, phase 20)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get
    from repro_torch.launch import roofline, specs
    from repro_torch.launch.serve import make_decode_step
    from repro_torch.models import build
    from repro_torch.tree import leaves

    cfg = specs.variant_for(get(arch), LAUNCH_SHAPE)
    shape = specs.SHAPES[LAUNCH_SHAPE]
    B, seq = shape["batch"], shape["seq"]
    api = build(cfg)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    caches = api.init_caches(B, seq + specs.CACHE_MARGIN)
    token = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor(seq, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    arg_bytes = sum(x.numel() * x.element_size()
                    for x in leaves((params, caches, token, pos)))
    assert arg_bytes == rec["argument_size_global"], (
        arch, arg_bytes, rec["argument_size_global"])
    step = make_decode_step(cfg)
    with FlopCounterMode(display=False) as fc:
        nxt, caches = step(params, caches, token, seq)
    torch.cuda.synchronize()
    assert fc.get_total_flops() == rec["flops_global"], (
        arch, fc.get_total_flops(), rec["flops_global"])
    assert nxt.shape == (B, 1) and 0 <= int(nxt.min()) \
        and int(nxt.max()) < cfg.vocab, nxt
    ms = _median_event_ms(lambda: step(params, caches, token, seq),
                          LAUNCH_WARMUP, LAUNCH_ITERS)
    busy = _launch_busy(lambda: step(params, caches, token, seq),
                        LAUNCH_BUSY_STEPS)
    one = roofline.analyze_record({
        **rec, "devices": 1, "flops": rec["flops_global"],
        "bytes_accessed": rec["bytes_accessed_global"]})
    del params, caches
    torch.cuda.empty_cache()
    return {"window": cfg.window, "B": B, "pos": seq,
            "flops_global": rec["flops_global"],
            "argument_size_global": arg_bytes,
            "allocated_bytes": allocated,
            "bytes_accessed_global": rec["bytes_accessed_global"],
            "step_ms": ms, "compute_ms": one["compute_s"] * 1e3,
            "memory_ms": one["memory_s"] * 1e3, "dominant": one["dominant"],
            "step_over_bound": ms / (max(one["compute_s"],
                                         one["memory_s"]) * 1e3),
            **busy}


def run_launch_phase(ops) -> None:
    """Phase 20 (``launch``): see the module docstring."""
    from repro_torch import device as device_mod
    from repro_torch.launch import dryrun, specs

    t_phase = time.perf_counter()
    dev = device_mod.resolve()
    ops.reset_launch_counts()
    combos = [(a, s) for a in LAUNCH_ARCHS for s in specs.SHAPES]
    jobs = min(len(combos), os.cpu_count() or 1)
    t0 = time.perf_counter()
    records, failures = dryrun.run_all(combos, False,
                                       str(OUT_DIR / "dryrun"), jobs=jobs)
    dry_s = time.perf_counter() - t0
    assert not failures, failures
    assert len(records) == len(combos)
    for rec in records.values():
        assert rec["flops_global"] > 0 and rec["bytes_accessed_global"] > 0
        assert {k for k, v in rec.items() if v is None} == \
            set(dryrun.NULL_FIELDS)
    card = {arch: _launch_card_step(arch, records[arch, LAUNCH_SHAPE], dev)
            for arch in LAUNCH_CARD_ARCHS}
    assert not ops.LAUNCH_COUNTS, dict(ops.LAUNCH_COUNTS)
    emit({"phase": "launch",
          "dryrun": {"archs": list(LAUNCH_ARCHS), "mesh": "single",
                     "records": len(records), "jobs": jobs,
                     "wall_s": dry_s,
                     "lower_s_sum": sum(r["lower_s"]
                                        for r in records.values())},
          "card": card, "phase_wall_s": time.perf_counter() - t_phase})


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    global STARTED
    STARTED = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # phases 3 to 9's reference runs: the process starts beside the build
    refs = _ReferenceRuns()
    try:
        return _drive(refs)
    finally:
        refs.close()


def _drive(refs) -> int:
    """Every phase in order (``main`` checks the card and the tree)."""
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build, flash, fused, gram, ops, ref
    from repro_torch.kernels import quadform as qf
    from repro_torch.kernels import rff as rffmod

    dev = device_mod.resolve("cuda")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(
        _build.BUILD_INFO.get("log", "(cached build)"))
    # the launch floor: one PyTorch kernel on one element
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1.0))
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "precision": device_mod.precision_flags(),
          "build_s": build_s, "build_cached": _build.BUILD_INFO["cached"],
          "launch_floor_ms": floor["ms"],
          "launch_floor_device_ms": floor["device_ms"]})

    tuned = check_autotune(fused, rffmod, gram, qf, dev,
                           torch.Generator().manual_seed(1))
    emit({"phase": "autotune", "ops": tuned})
    gen = torch.Generator().manual_seed(0)
    results = {}
    checks = (
        ("sv_predict", lambda: check_sv_predict(fused, ref, dev, gen)),
        ("quadform", lambda: check_quadform(qf, ops, ref, dev, gen)),
        ("primal_step_rff",
         lambda: check_primal_step(fused, ref, dev, gen, True)),
        ("primal_step_linear",
         lambda: check_primal_step(fused, ref, dev, gen, False)),
        ("rff", lambda: check_rff(rffmod, ref, dev, gen)),
        ("flash", lambda: check_flash(flash, ref, dev, gen)),
        ("gram", lambda: check_gram(gram, ref, dev, gen)))
    for name, fn in checks:
        errs, ms, plain, (bms, by) = fn()
        results[name] = dict(errs=errs, ms=ms["ms"], plain_ms=plain["ms"],
                             bound_ms=bms, bound_by=by,
                             device_ms=ms["device_ms"],
                             plain_device_ms=plain["device_ms"],
                             **{k: v for k, v in ms.items()
                                if k not in ("ms", "device_ms")})
        emit({"phase": "kernel", "name": name, "max_abs_err": errs,
              **{k: v for k, v in results[name].items() if k != "errs"},
              **({"earlier": EARLIER[name]} if name in EARLIER else {})})
        torch.cuda.empty_cache()
    node_shapes = check_node_shapes(fused, ops, qf, ref,
                                    results["rff"]["by_bucket"], dev, gen)
    slice_shapes = check_slice_shapes(fused, ops, ref, dev, gen)
    mesh_shapes = check_mesh_shapes(fused, ops, ref, dev, gen)
    torch.cuda.synchronize()

    # the runs use deterministic algorithms (after the kernel timings:
    # in this mode torch.empty fills its output, an extra kernel)
    torch.use_deterministic_algorithms(True)
    # before the serving runs' long profiles, after which the profiler
    # has lost whole windows of this phase's ms-long calls
    run_sync_route(ops, ref)
    totals: dict = {}
    runs: dict = {}
    run_e2e(ops, totals, runs, refs)
    bucket_counts = run_serving(ops, totals, runs, refs)
    run_async(ops, totals, runs, refs)
    grouped = run_sweeps(ops, totals, runs, refs)
    run_population_phase(ops, totals, runs, refs)
    run_mesh_phase(ops, totals, runs)
    run_oracle_phase(runs, refs)
    refs.close()
    # rff's line at the main path's mix of bucket sizes
    rff_line = results["rff"]
    counts = bucket_counts["serve_rff_dynamic"]
    weighted = bucket_weighted(rff_line["by_bucket"], counts)
    earlier = EARLIER["rff"]["device_ms_by_bucket"]
    emit({"phase": "rff_buckets", "bucket_counts": counts,
          "by_bucket": rff_line["by_bucket"], "weighted": weighted,
          "earlier_weighted_device_ms": sum(
              earlier[str(M)] * c for M, c in counts.items())
          / sum(counts.values())})
    rff_line.update({f"weighted_{k}": v for k, v in weighted.items()},
                    weighted_by=counts)
    check_rows_below_threshold(dev, gen)
    results["gram"]["errs"]["main"] = run_gram_path(ops, ref, totals)
    torch.cuda.empty_cache()
    run_lm_serve(ops, totals)
    torch.cuda.empty_cache()
    run_train_phase(ops)
    torch.cuda.empty_cache()
    run_ssm_phase(ops)
    dense_shapes = run_dense_phase(ops, totals, flash, ref)
    torch.cuda.empty_cache()
    run_long_phase(ops)
    torch.cuda.empty_cache()
    vlm_shapes = run_vlm_phase(ops, totals, flash, ref)
    torch.cuda.empty_cache()
    run_mla_phase(ops)
    torch.cuda.empty_cache()
    moe_shapes = run_moe_phase(ops, totals, flash, ref)
    torch.cuda.empty_cache()
    run_audio_phase(ops)
    torch.cuda.empty_cache()
    run_launch_phase(ops)

    tuned_op = {"sv_predict": "sv_predict", "quadform": "quadform",
                "primal_step_rff": "rff_step",
                "primal_step_linear": "linear_step", "rff": "rff",
                "gram": "gram"}
    meta = {
        "sv_predict": ("src/repro_torch/kernels/csrc/sv_predict.cu",
                       "src/repro/kernels/fused.py:100", ("sv_predict",)),
        "quadform": ("src/repro_torch/kernels/csrc/quadform.cu",
                     "src/repro/kernels/quadform.py:83", ("quadform",)),
        "primal_step_rff": ("src/repro_torch/kernels/csrc/primal_step.cu",
                            "src/repro/kernels/fused.py:237", ("rff_step",)),
        "primal_step_linear": ("src/repro_torch/kernels/csrc/primal_step.cu",
                               "src/repro/kernels/fused.py:237",
                               ("linear_step",)),
        "rff": ("src/repro_torch/kernels/csrc/rff.cu",
                "src/repro/kernels/rff.py:50", ("rff",)),
        "flash": ("src/repro_torch/kernels/csrc/flash.cu",
                  "src/repro/kernels/flash.py:112", ("flash",)),
        "gram": ("src/repro_torch/kernels/csrc/gram.cu",
                 "src/repro/kernels/gram.py:78", ("gram",)),
    }
    kernels = []
    for name, (source, replaces, counters) in meta.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(totals.get(c, 0) for c in counters),
            "max_abs_err": max(r["errs"].values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # flash: scaled_dot_product_attention on the same bf16
            # tensors; no single PyTorch call computes the others (gram's
            # main kind is the gaussian)
            "library_ms": r.get("library_ms"), "device_ms": r["device_ms"],
            "plain_device_ms": r["plain_device_ms"],
            # gram's linear kind, beside torch.matmul(X, Y.T)
            **{k: r[k] for k in ("linear_ms", "linear_device_ms",
                                 "linear_bound_ms", "linear_library_ms",
                                 "linear_library_device_ms",
                                 # rff: the line's own numbers are M = 64's;
                                 # beside them the serving run's mix of
                                 # bucket sizes
                                 "weighted_by", "weighted_ms",
                                 "weighted_device_ms", "weighted_plain_ms",
                                 "weighted_bound_ms") if k in r},
            # the asynchronous runtime's one-node shapes
            **({"node_shapes": node_shapes[name]} if name in node_shapes
               else {}),
            # the sweep's stacked rows and grouped check, the population
            **({"slice_shapes": slice_shapes[name]} if name in slice_shapes
               else {}),
            # a mesh shard's shapes (phase 3's learners over 4 shards)
            **({"mesh_shapes": mesh_shapes[name]} if name in mesh_shapes
               else {}),
            # flash at the dense configs' prefill shapes (phase 14)
            **({"lm_dense_shapes": dense_shapes} if name == "flash"
               else {}),
            # flash at qwen2_vl_2b's prefill shape (phase 16)
            **({"lm_vlm_shapes": vlm_shapes} if name == "flash" else {}),
            # flash at the MoE configs' prefill shapes (phase 18)
            **({"lm_moe_shapes": moe_shapes} if name == "flash" else {}),
            # the geometry phase 2's search chose at the main path's shape
            **({"autotune": {k: tuned[tuned_op[name]][k] for k in (
                "choice", "source", "times_ms")}} if name in tuned_op
               else {}),
            **(grouped if name == "quadform" else {})})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
