"""Dry run of every (arch x shape x mesh) step on ``meta`` tensors (port
of ``repro/launch/dryrun.py``).

For each combination this script:
  1. builds the step the reference lowers (the protocol train step,
     prefill or one-token decode) at the registry's full config, on the
     ``meta`` trees of ``launch/specs.py`` and ``train_state_specs``, with
     the partition specs of ``launch/sharding.py`` on the production mesh
     (16 x 16, or 2 x 16 x 16 with ``--multi-pod``);
  2. runs it on ``meta`` (shapes and dtypes, no storage, no device)
     under ``torch.utils.flop_counter.FlopCounterMode`` and a dispatch
     mode that sums the bytes of every aten op;
  3. writes a JSON record in the reference's schema, which
     ``launch/roofline.py`` reads.

It needs no card.  XLA's ``cost_analysis``, ``memory_analysis`` and the
post-partitioning HLO have no PyTorch counterpart, so the fields are
filled as follows:

- ``flops``: per device, ``flops_global`` (the FlopCounterMode total of
  the global step) divided evenly by ``devices``; ``flops_basis`` says
  so.  FlopCounterMode counts matrix products, convolutions and
  attention; it counts no elementwise op or reduction.
- ``bytes_accessed``: per device, ``bytes_accessed_global`` (the
  operand and result bytes of every aten op the step dispatches, view
  and allocation ops left out: an unfused count) divided evenly;
  ``bytes_basis`` says so.
- ``argument_size`` / ``output_size``: exact per-device bytes of the
  inputs and outputs under their specs (``sharding.per_device_bytes``),
  the global bytes beside them (``argument_size_global``,
  ``output_size_global``).
- ``lower_s``: the seconds it took to build and count the step.
- ``null`` (``{}`` for ``collective_bytes``): ``transcendentals``,
  ``temp_size``, ``generated_code_size``, ``collective_bytes``,
  ``collective_total``, ``n_collective_ops`` and ``compile_s``
  (``NULL_FIELDS``).  A one-process port has no partitioner and no
  compiler to produce them.

``meta`` tensors cannot be read on the host, and the live steps read
two values there, so the dry run does not simply call them:

- decode: the position goes in as a host int (the shape's ``seq``);
  ``input_specs``' 0-d ``pos`` stays in the argument tree for its bytes.
- train: ``apply_protocol`` reads the round counter and the violation
  bit on the host, which ``meta`` cannot decide.  So the record counts
  the m learners' local steps (``launch.train.local_update`` and the
  copies into the new stacks; every learner's shapes are learner 0's,
  so the count is m times learner 0's, ``flops_local`` /
  ``bytes_local``) and the protocol's round apart (``flops_sync`` /
  ``bytes_sync``), the latter at its worst case, a sync every round:
  the dynamic local conditions, then ``apply_protocol``'s continuous
  round with its counter on the host (``protocol_sync``).  The mean of
  the m losses is in the totals only.

The reference lowers with ``remat=True, unroll_scan=True``; the port's
config keeps those fields and ignores them, so its counts hold no
recomputation.  ``REPRO_BASELINE=1`` counts the pre-optimization forms
the reference's baseline records were taken with: the einsum MoE
dispatch (``moe.moe_forward_einsum``) and grouped attention
(``attention._sdpa_grouped``) everywhere.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod]
(``--all`` counts its combos in one spawned process a CPU core, at
most one a combo.)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import all_arch_ids, get
from ..core import protocol
from ..core.protocol import ProtocolConfig, ProtocolState
from ..models import attention, build, moe
from ..models.config import ModelConfig
from ..optim import OptimizerConfig, make as make_optimizer
from ..tree import leaves, tree_map
from . import sharding as shd
from . import specs as specs_mod
from .mesh import data_axes, make_production_mesh, num_learners
from .serve import make_decode_step, make_prefill_step
from .specs import SHAPES, variant_for
from .train import TrainState, local_update, train_state_specs

#: the record fields the port cannot fill (``collective_bytes`` is ``{}``)
NULL_FIELDS = ("transcendentals", "temp_size", "generated_code_size",
               "collective_total", "n_collective_ops", "compile_s")

FLOPS_BASIS = ("FlopCounterMode over the global step on meta tensors "
               "(matrix products, convolutions, attention), split evenly "
               "over the devices: not a partitioned program")
BYTES_BASIS = ("operand plus result bytes of every aten op of the global "
               "step (views and allocations left out), unfused, split "
               "evenly over the devices")

# the train step the reference lowers
TRAIN_PCFG = ProtocolConfig(kind="dynamic", delta=1e-3)
# the round the protocol's count takes: a sync every round
SYNC_PCFG = ProtocolConfig(kind="continuous")
TRAIN_OPT = OptimizerConfig(kind="sgd", lr=1e-2, momentum=0.9)

_aten = torch.ops.aten
# ops that move no data: their results alias an input or are not written
_NO_DATA = frozenset((_aten._unsafe_view.default, _aten.empty.memory_format,
                      _aten.empty_strided.default, _aten.empty_like.default,
                      _aten.new_empty.default,
                      _aten.new_empty_strided.default))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op dispatched
    under it, except views and allocations (``total``)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func in _NO_DATA):
            self.total += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def count(thunk: Callable[[], Any]) -> Tuple[Any, int, int]:
    """Runs ``thunk`` under both counters: (its result, FLOPs, bytes)."""
    # the byte counter innermost: it sees each op as the step dispatches
    # it, before FlopCounterMode decomposes any
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        out = thunk()
    return out, flops.get_total_flops(), nbytes.total


@contextlib.contextmanager
def _baseline_emulation():
    """REPRO_BASELINE=1: the pre-optimization forms (einsum MoE dispatch,
    grouped attention everywhere), restored on exit."""
    saved = attention._sdpa, moe.moe_forward
    attention._sdpa = attention._sdpa_grouped
    moe.moe_forward = moe.moe_forward_einsum
    try:
        yield
    finally:
        attention._sdpa, moe.moe_forward = saved


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


class Part(NamedTuple):
    """A counted part of a step: ``run()`` once, its counts ``times``."""
    name: str
    run: Callable[[], Any]
    times: int


class Combo(NamedTuple):
    kind: str
    parts: List[Part]           # run in order; the last returns the outputs
    args: tuple                 # the step's inputs (meta trees)
    in_pspecs: tuple
    out_pspecs: tuple


def protocol_sync(pcfg: ProtocolConfig, stacked, state: ProtocolState,
                  host_step: torch.Tensor):
    """The protocol's round at its worst case, a sync every round, made
    of the live operators: ``pcfg``'s local conditions (dynamic) and
    ``apply_protocol``'s continuous round (the average, the divergence,
    the broadcast and the counters of a sync).  ``meta`` cannot be read
    on the host, so the round counter goes in as ``host_step``, a 0-d
    CPU tensor of ``state.step``'s dtype (no count depends on its
    value).  Returns ``apply_protocol``'s (synced stack, new state)."""
    if pcfg.kind == "dynamic":
        conditions = protocol.group_local_conditions if pcfg.per_group \
            else protocol.local_conditions
        delta = protocol._delta_eff(pcfg, 1, state.delta_scale,
                                    leaves(stacked)[0].device)
        torch.any(conditions(stacked, state.reference, delta))
    return protocol.apply_protocol(SYNC_PCFG, stacked,
                                   state._replace(step=host_step))


def _train_parts(cfg: ModelConfig, pcfg: ProtocolConfig,
                 opt_cfg: OptimizerConfig, state: TrainState,
                 batch) -> List[Part]:
    """``make_train_step``'s step in three parts: learner 0's pass of
    the learner loop (counted m times), the protocol's round and the
    mean of the m losses."""
    api, opt = build(cfg), make_optimizer(opt_cfg)
    m = leaves(state.params)[0].shape[0]
    host_step = torch.zeros((), dtype=state.pstate.step.dtype)
    new = {}

    def learner():
        new["params"] = tree_map(torch.empty_like, state.params)
        new["opt"] = tree_map(torch.empty_like, state.opt)
        p_0, o_0, new["loss"] = local_update(
            api, opt, tree_map(lambda x: x[0], state.params),
            tree_map(lambda x: x[0], state.opt), state.step,
            {k: v[0] for k, v in batch.items()})
        tree_map(lambda dst, src: dst[0].copy_(src), new["params"], p_0)
        tree_map(lambda dst, src: dst[0].copy_(src), new["opt"], o_0)

    def sync():
        new["params"], new["pstate"] = protocol_sync(
            pcfg, new["params"], state.pstate, host_step)

    def loss():
        return (TrainState(params=new["params"], opt=new["opt"],
                           pstate=new["pstate"], step=state.step + 1),
                torch.mean(torch.stack([new["loss"]] * m)))

    return [Part("local", learner, m), Part("sync", sync, 1),
            Part("loss", loss, 1)]


def build_combo(arch: str, shape_name: str, mesh) -> Combo:
    """The step of one (arch, shape) on ``mesh``: its counted parts, its
    inputs on ``meta`` and the specs of its inputs and outputs."""
    cfg0 = get(arch)
    cfg = variant_for(cfg0, shape_name)
    shape = SHAPES[shape_name]
    model_size = mesh.shape["model"]
    daxes = data_axes(mesh)
    dax = daxes if len(daxes) > 1 else daxes[0]
    nd = num_learners(mesh)
    B = shape["batch"]

    if shape["kind"] == "train":
        m = nd
        state = train_state_specs(cfg, m, TRAIN_OPT)
        batch = specs_mod.train_batch_specs(cfg, m, shape)
        scalar = shd.PSpec()
        state_pspec = TrainState(
            params=shd.param_pspec(state.params, model_size, daxes),
            opt=shd.param_pspec(state.opt, model_size, daxes),
            pstate=ProtocolState(
                reference=shd.param_pspec(state.pstate.reference,
                                          model_size, daxes),
                step=scalar, syncs=scalar, bytes_sent=scalar,
                last_divergence=scalar, delta_scale=scalar),
            step=scalar)
        return Combo("train",
                     _train_parts(cfg, TRAIN_PCFG, TRAIN_OPT, state, batch),
                     (state, batch),
                     (state_pspec, shd.batch_pspec(batch, daxes)),
                     (state_pspec, scalar))

    params = specs_mod.param_specs(cfg)
    params_pspec = shd.param_pspec(params, model_size)

    if shape["kind"] == "prefill":
        fn = make_prefill_step(cfg)
        batch = specs_mod.prefill_batch_specs(cfg, shape)
        caches = specs_mod.cache_specs(cfg, B, shape["seq"])
        cache_pspec = shd.cache_pspec(caches, daxes, B, nd, model_size)
        return Combo("prefill",
                     [Part("step", lambda: fn(params, batch, caches), 1)],
                     (params, batch, caches),
                     (params_pspec, shd.batch_pspec(batch, daxes),
                      cache_pspec),
                     (shd.PSpec(), cache_pspec))

    # decode: one token at position seq, after seq tokens of context
    fn = make_decode_step(cfg)
    dspecs = specs_mod.input_specs(cfg0, shape_name)
    token, pos, caches = dspecs["token"], dspecs["pos"], dspecs["caches"]
    tok_pspec = shd.PSpec(dax if B % nd == 0 else None, None)
    cache_pspec = shd.cache_pspec(caches, daxes, B, nd, model_size)
    return Combo("decode",
                 [Part("step",
                       lambda: fn(params, caches, token, shape["seq"]), 1)],
                 (params, caches, token, pos),
                 (params_pspec, cache_pspec, tok_pspec, shd.PSpec()),
                 (tok_pspec, cache_pspec))


def count_combo(combo: Combo, mesh) -> Dict[str, Any]:
    """Runs the combo's parts under the counters; the record's counts
    and sizes (global and per device)."""
    baseline = os.environ.get("REPRO_BASELINE") == "1"
    counts = {}
    with _baseline_emulation() if baseline else contextlib.nullcontext():
        for part in combo.parts:
            outputs, f, b = count(part.run)
            counts[part.name] = (f * part.times, b * part.times)
    devices = mesh.size
    flops_global = sum(f for f, _ in counts.values())
    bytes_global = sum(b for _, b in counts.values())
    arg_global = sum(x.numel() * x.element_size()
                     for x in leaves(combo.args))
    out_global = sum(x.numel() * x.element_size() for x in leaves(outputs))
    out = {
        "flops": flops_global / devices,
        # reprolint: allow[ACC01] dry-run cost model: an even split of memory traffic, not the ledger
        "bytes_accessed": bytes_global / devices,
        "argument_size": shd.per_device_bytes(combo.args, combo.in_pspecs,
                                              mesh),
        "output_size": shd.per_device_bytes(outputs, combo.out_pspecs,
                                            mesh),
        "flops_global": flops_global,
        "bytes_accessed_global": bytes_global,
        "argument_size_global": arg_global,
        "output_size_global": out_global,
        "flops_basis": FLOPS_BASIS,
        "bytes_basis": BYTES_BASIS,
        "baseline": baseline,
    }
    if combo.kind == "train":
        out.update(m=leaves(combo.args[0].params)[0].shape[0],
                   flops_local=counts["local"][0],
                   flops_sync=counts["sync"][0],
                   bytes_local=counts["local"][1],
                   bytes_sync=counts["sync"][1])
    return out


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            mesh=None) -> Dict[str, Any]:
    """Builds, counts and records one combination (on ``mesh`` when
    given, else the production mesh); writes
    ``<outdir>/<arch>__<shape>__<single|multi>.json``."""
    mesh_tag = "multi" if multi_pod else "single"
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    combo = build_combo(arch, shape_name, mesh)
    counted = count_combo(combo, mesh)
    t_lower = time.perf_counter() - t0

    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "devices": int(mesh.size),
        "kind": SHAPES[shape_name]["kind"],
        "flops": counted["flops"],
        "bytes_accessed": counted["bytes_accessed"],
        "transcendentals": None,
        "argument_size": counted["argument_size"],
        "output_size": counted["output_size"],
        "temp_size": None,
        "generated_code_size": None,
        "collective_bytes": {},
        "collective_total": None,
        "lower_s": t_lower,
        "compile_s": None,
        "n_collective_ops": None,
        **{k: v for k, v in counted.items() if k not in (
            "flops", "bytes_accessed", "argument_size", "output_size")},
    }

    print(f"== {arch} x {shape_name} x {mesh_tag} ({mesh.size} devices) ==")
    print("sizes:", {k: record[k] for k in ("argument_size", "output_size")})
    print("counts: flops=%.3e bytes=%.3e (per device)"
          % (record["flops"], record["bytes_accessed"]))
    print(f"lower={t_lower:.1f}s")

    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{arch}__{shape_name}__{mesh_tag}.json")
    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def _run_caught(arch: str, shape_name: str, multi_pod: bool, outdir: str):
    """``run_one``, its error as a traceback: (record or None, error)."""
    try:
        return run_one(arch, shape_name, multi_pod, outdir), None
    except Exception:       # noqa: BLE001 -- every combo is reported
        return None, traceback.format_exc()


def run_all(combos, multi_pod: bool, outdir: str, jobs: int = 1):
    """``run_one`` over (arch, shape) ``combos``, in ``jobs`` spawned
    processes when above 1 (a combo is Python-bound: they run side by
    side).  Returns ({(arch, shape): record}, [(arch, shape, error)])."""
    args = [(a, s, multi_pod, outdir) for a, s in combos]
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(jobs) as pool:
            results = pool.starmap(_run_caught, args, chunksize=1)
    else:
        results = [_run_caught(*a) for a in args]
    records, failures = {}, []
    for (arch, shape_name), (rec, err) in zip(combos, results):
        if err is None:
            records[arch, shape_name] = rec
        else:
            print(err, file=sys.stderr)
            failures.append((arch, shape_name, err.strip().splitlines()[-1]))
    return records, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in all_arch_ids() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]

    _, failures = run_all(combos, args.multi_pod, args.outdir,
                          jobs=min(len(combos), os.cpu_count() or 1))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print(f"all {len(combos)} combos built and counted OK")


if __name__ == "__main__":
    main()
