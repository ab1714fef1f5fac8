"""Protocol training step and runnable trainer (port of
``repro/launch/train.py``).

The paper's technique at LM scale: every data-parallel group is a
learner with its own model replica (a stacked leading axis m).  Each
step every learner takes a local optimizer step on its own batch, then
the synchronization operator runs: the dynamic one checks the local
conditions ||theta_i - r||^2 <= Delta and averages the parameters only
on a violation.

The port keeps one process and one card: learner i's loss and
gradients are taken on its own slice, one learner at a time, so only
one learner's autograd graph and gradients are alive at once.  The
step writes each learner's new parameters into a fresh stack and then
calls ``core.protocol.apply_protocol``.  No step writes in place: the
caller's ``TrainState`` stays as it was.  ``local_update`` (one
learner's step) is a module function, so the dry run
(``launch/dryrun.py``) counts it on its own; ``train_state_specs`` is
the state's tree on ``meta`` tensors.

A parameter tree may mix dtypes (the bf16 Mamba-2 tree holds float32
``A_log``, ``D`` and ``dt_bias``): the optimizer computes each update in
float32 and casts it back to its leaf's dtype, the protocol widens each
leaf to float32 for its distances and averages, and a sync is charged
each leaf's own bytes.

Run:  python -m repro_torch.launch.train --steps 20         (the card)
      python -m repro_torch.launch.train --device cpu
(``--arch`` defaults to mamba2_130m, as the reference's CLI; the smoke
variant of the architecture, as there.)
"""
from __future__ import annotations

import argparse
import time
from typing import Any, NamedTuple, Tuple, Union

import numpy as np
import torch

from .. import device as device_mod
from ..core import protocol
from ..core.protocol import ProtocolConfig, ProtocolState
from ..models import build
from ..models.config import ModelConfig
from ..optim import OptimizerConfig, make as make_optimizer
from ..tree import leaves, tree_map, unflatten
from .specs import META, param_specs

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree          # stacked (m, ...)
    opt: PyTree             # stacked optimizer state
    pstate: ProtocolState   # stacked reference model + counters
    step: torch.Tensor      # int32


def _stack(tree: PyTree, m: int) -> PyTree:
    return tree_map(lambda x: x[None].expand((m,) + tuple(x.shape)).clone(),
                    tree)


def init_train_state(seed_or_generator: Union[int, torch.Generator],
                     cfg: ModelConfig, m: int, opt_cfg: OptimizerConfig,
                     device=None) -> TrainState:
    """m learners at one random model (drawn on ``device``; None is the
    CUDA card), the reference stacked beside them."""
    dev = device_mod.resolve(device)
    params0 = build(cfg).init(seed_or_generator, device=dev)
    return _train_state(params0, m, opt_cfg, dev)


def _train_state(params0: PyTree, m: int, opt_cfg: OptimizerConfig,
                 dev: torch.device) -> TrainState:
    opt = make_optimizer(opt_cfg)
    return TrainState(
        params=_stack(params0, m),
        opt=_stack(opt.init(params0), m),
        pstate=protocol.init_state(params0, m),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def train_state_specs(cfg: ModelConfig, m: int,
                      opt_cfg: OptimizerConfig) -> TrainState:
    """The train state of m learners on ``meta`` tensors (shapes and
    dtypes, no storage; for the dry run): ``init_train_state``'s tree
    from ``launch.specs.param_specs``."""
    return _train_state(param_specs(cfg), m, opt_cfg, META)


def local_update(api, opt, params, opt_state, step, batch):
    """One learner's local step: its loss and gradients on its own
    batch, then the optimizer's update.  Returns (new parameters, new
    optimizer state, detached loss)."""
    params = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = api.loss(params, batch)
    flat = leaves(params)
    grads = unflatten(params, torch.autograd.grad(loss, flat))
    params = tree_map(lambda x: x.detach(), params)
    new_params, new_opt = opt.update(grads, opt_state, params, step)
    return new_params, new_opt, loss.detach()


def make_train_step(cfg: ModelConfig, pcfg: ProtocolConfig,
                    opt_cfg: OptimizerConfig):
    """``train_step(state, batch) -> (state, mean loss)``; ``batch``
    holds ``tokens`` and ``labels`` of shape (m, B, S), and a VLM's
    ``embeds`` (m, B, vision_tokens, d) before them or an audio model's
    ``frames`` (m, B, n_audio_frames, d).  The loss is ``build(cfg).loss``:
    a MoE model's carries its aux loss, an encoder-decoder's is
    ``encdec_loss``."""
    api = build(cfg)
    opt = make_optimizer(opt_cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        m = leaves(state.params)[0].shape[0]
        new_params = tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.device),
            state.params)
        new_opt = tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device=x.device),
            state.opt)
        losses = []
        for i in range(m):
            p_i, o_i, loss = local_update(
                api, opt, tree_map(lambda x: x[i], state.params),
                tree_map(lambda x: x[i], state.opt), state.step,
                {k: v[i] for k, v in batch.items()})
            tree_map(lambda dst, src: dst[i].copy_(src), new_params, p_i)
            tree_map(lambda dst, src: dst[i].copy_(src), new_opt, o_i)
            losses.append(loss)
            del p_i, o_i
        synced, new_pstate = protocol.apply_protocol(pcfg, new_params,
                                                     state.pstate)
        return (TrainState(params=synced, opt=new_opt, pstate=new_pstate,
                           step=state.step + 1),
                torch.mean(torch.stack(losses)))

    return train_step


# ---------------------------------------------------------------------------
# Runnable trainer
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2, help="per-learner batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--protocol", default="dynamic",
                    choices=["none", "continuous", "periodic", "dynamic"])
    ap.add_argument("--delta", type=float, default=1e-4)
    ap.add_argument("--period", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)

    from ..configs import get

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    m = args.learners
    pcfg = ProtocolConfig(kind=args.protocol, delta=args.delta,
                          period=args.period)
    opt_cfg = OptimizerConfig(kind="sgd", lr=args.lr, momentum=0.0)
    dev = device_mod.resolve(args.device)

    state = init_train_state(0, cfg, m, opt_cfg, device=dev)
    step_fn = make_train_step(cfg, pcfg, opt_cfg)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for t in range(args.steps):
        toks = rng.integers(0, cfg.vocab, (m, args.batch, args.seq + 1))
        batch = {
            "tokens": torch.as_tensor(toks[..., :-1], dtype=torch.int64,
                                      device=dev),
            "labels": torch.as_tensor(toks[..., 1:], dtype=torch.int64,
                                      device=dev),
        }
        if cfg.arch_type == "vlm":
            batch["embeds"] = torch.as_tensor(np.asarray(
                rng.normal(size=(m, args.batch, cfg.vision_tokens,
                                 cfg.d_model)), np.float32), device=dev)
        if cfg.arch_type == "audio":
            batch["frames"] = torch.as_tensor(np.asarray(
                rng.normal(size=(m, args.batch, cfg.n_audio_frames,
                                 cfg.d_model)), np.float32), device=dev)
        state, loss = step_fn(state, batch)
        print(f"step {t:4d} loss={float(loss):8.4f} "
              f"syncs={int(state.pstate.syncs):3d} "
              f"divergence={float(state.pstate.last_divergence):10.3e} "
              f"bytes={int(state.pstate.bytes_sent):d}")
    print(f"done in {time.time() - t0:.1f}s; "
          f"{int(state.pstate.syncs)}/{args.steps} rounds synchronized")


if __name__ == "__main__":
    main()
