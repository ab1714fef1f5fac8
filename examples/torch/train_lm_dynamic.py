"""End-to-end driver on PyTorch: train a ~100M-parameter LM with the
dynamic protocol for a few hundred steps.

The model is the mamba2-130m architecture (full width, reduced depth by
default so a CPU run finishes in minutes; pass --full-depth for all 24
layers).  Four learners run local SGD on their own token streams; the
dynamic operator synchronizes them only on local-condition violations.
Checkpoints + protocol state are saved periodically in the reference's
file format (``repro_torch.checkpoint``).  Runs on the CUDA card unless
``--device cpu`` is given; prints examples/train_lm_dynamic.py's lines
(``s/step`` is wall time).

    python examples/torch/train_lm_dynamic.py --steps 300 [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.launch.train import (TrainState, init_train_state,  # noqa: E402
                                      make_train_step)
from repro_torch.models import count_params  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--delta", type=float, default=5e-3)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--full-depth", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    return ap.parse_args(argv)


def model_config(args):
    cfg = get("mamba2_130m")
    if not args.full_depth:
        cfg = cfg.with_(n_layers=4)           # ~35M params, CPU-friendly
    return cfg


def optimizer_config(args) -> OptimizerConfig:
    return OptimizerConfig(kind="sgd", lr=args.lr, momentum=0.9,
                           grad_clip=1.0)


def train(args, cfg, state: TrainState, device) -> TrainState:
    """``args.steps`` protocol rounds from ``state`` (m stacked learners
    on ``device``), printing the reference driver's lines; returns the
    last state."""
    m = args.learners
    n = count_params(tree_map(lambda x: x[0], state.params))
    print(f"arch=mamba2_130m layers={cfg.n_layers} params={n/1e6:.1f}M "
          f"learners={m} protocol=dynamic(delta={args.delta})")

    pcfg = ProtocolConfig(kind="dynamic", delta=args.delta)
    step_fn = make_train_step(cfg, pcfg, optimizer_config(args))
    rng = np.random.default_rng(0)

    t0 = time.time()
    model_bytes = n * 4
    for t in range(args.steps):
        toks = rng.integers(0, cfg.vocab, (m, args.batch, args.seq + 1))
        half = args.seq // 2
        toks[..., half + 1: 2 * half + 1] = toks[..., 1: half + 1]  # copy task
        batch = {"tokens": torch.as_tensor(toks[..., :-1], device=device),
                 "labels": torch.as_tensor(toks[..., 1:], device=device)}
        state, loss = step_fn(state, batch)
        if t % 20 == 0 or t == args.steps - 1:
            syncs = int(state.pstate.syncs)
            comm_gb = 2 * m * model_bytes * syncs / 1e9
            print(f"step {t:4d} loss={float(loss):7.4f} syncs={syncs:4d} "
                  f"divergence={float(state.pstate.last_divergence):9.2e} "
                  f"comm={comm_gb:7.3f}GB "
                  f"({(time.time()-t0)/(t+1):.2f}s/step)")
        if args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            path = ckpt.save_step(args.ckpt_dir, t + 1, state)
            print(f"  checkpoint -> {path}")

    syncs = int(state.pstate.syncs)
    saved = 1.0 - syncs / args.steps
    print(f"\ndone: {syncs}/{args.steps} rounds communicated "
          f"({saved*100:.0f}% of parameter all-reduces eliminated by the "
          f"dynamic protocol)")
    return state


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = device_mod.resolve(args.device)
    cfg = model_config(args)
    state = init_train_state(0, cfg, args.learners, optimizer_config(args),
                             device=dev)
    train(args, cfg, state, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
