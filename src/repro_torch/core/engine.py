"""The device-resident engine (port of ``repro/core/engine.py:644-713``).

``run`` simulates T rounds of m learners under one protocol with the
learner state, the reference model, the byte ledger and every
per-round observable on the device.  Where the reference compiles one
``lax.scan``, the port runs a Python loop over T that writes each
round's per-learner outputs into preallocated (T, m) device tensors;
the host reads them once, at the end.

One round is :func:`make_protocol_step`'s ``step``, the counterpart
of the reference's scan body: ``run`` iterates it, and the serving
engine (serving/engine.py) drives the same function one labeled round
at a time, so a serving run's protocol view equals ``run``'s bitwise
on the same device.

Control flow: ``lax.cond`` becomes ``if``.  Periodic syncs and the
dynamic protocol's check rounds are decided on the host from ``t``
alone; the only value that crosses to the host during a run is the
dynamic protocol's violation bit, once per check round.

Exactness contract against the reference engine: ``sync_rounds``,
``num_syncs`` and ``cumulative_bytes`` are equal; per-learner losses,
errors, divergences and epsilons agree within the parity tolerance;
the cross-learner sum runs on the host exactly as the reference's
``assemble_sim_result`` does.  A run is a pure function of its seeds:
no kernel or reduction on this path sums in a run-dependent order.

Single device only.  ``mesh=`` and ``participation=`` and ``sweep``
wait for later slices (ROADMAP.md) and raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import device as device_mod
from . import substrate as substrate_mod
from .learners import LearnerConfig
from .protocol import PROTOCOL_KIND_CODES, ProtocolConfig
from .rff import RFFSpec
from .simulation import SimResult
from .substrate import Substrate

LearnerLike = Union[Substrate, LearnerConfig, RFFSpec]

TOPOLOGIES = ("coordinator", "allreduce")

#: The reference keeps per-sync bytes in int32 (engine.py:149-157).
_INT32_LIMIT = 2**31


def _err_terms(loss: str, yhat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-learner service errors: mistakes for hinge (``yhat >= 0``
    predicts +1), squared error otherwise."""
    if loss == "hinge":
        pred = torch.where(yhat >= 0, 1.0, -1.0)
        return (pred != y).to(torch.float32)
    return (yhat - y) ** 2


def allreduce_cost(sub: Substrate, m: int) -> int:
    """Ring bytes of one sync, refused where the reference's int32
    byte column would overflow."""
    cost = int(sub.allreduce_sync_bytes(m))
    if cost >= _INT32_LIMIT:
        raise ValueError(
            f"per-sync ring bytes {cost} for m={m} overflow the byte "
            "ledger's int32; use the host accounting at this scale")
    return cost


class ScanParams(NamedTuple):
    """The protocol parameters a step reads, as host numbers."""

    delta: float        # the reference's float32 delta
    period: int
    mini_batch: int


def params_of(pcfg: ProtocolConfig) -> ScanParams:
    """The step's view of one ProtocolConfig (the reference's
    ``params_of``): delta rounded to float32 as the reference traces it."""
    return ScanParams(delta=float(np.float32(pcfg.delta)),
                      period=int(pcfg.period),
                      mini_batch=int(pcfg.mini_batch))


def make_protocol_step(sub: Substrate, kind: str, *,
                       record_divergence: bool = False,
                       topology: str = "coordinator"):
    """One protocol round as a function — the body ``run`` iterates.

    Returns ``step(params, carry, xs) -> (carry, outs)`` with
    ``carry = (stacked learner state, reference, ledger)``,
    ``xs = (x (m, d), y (m,), t int)`` and
    ``outs = (loss (m,), err (m,), bytes, divergence, sync_flag, eps)``.
    The flag is a host ``bool``; on a round without a sync ``bytes`` is
    the int 0 and ``eps`` the float 0.0, and ``divergence`` is 0.0
    unless it is recorded (``record_divergence`` or
    ``sub.free_divergence``).  Everything else stays on the device.
    """
    if kind not in PROTOCOL_KIND_CODES:
        raise ValueError(f"unknown protocol kind {kind!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {TOPOLOGIES}")
    record = bool(record_divergence) or sub.free_divergence

    def step(params: ScanParams, carry, xs):
        state, reference, ledger = carry
        x, y, t = xs
        state, losses, yhat = sub.round_stacked(state, (x, y))
        err = _err_terms(sub.loss, yhat, y)
        models = sub.models_of(state)

        if kind == "none":
            do_sync = False
        elif kind == "continuous":
            do_sync = True
        elif kind == "periodic":
            do_sync = (t + 1) % params.period == 0
        else:   # dynamic: check the local conditions every mini_batch rounds
            do_sync = ((t + 1) % params.mini_batch == 0 and bool(
                torch.any(sub.dist_to_ref(models, reference) > params.delta)))

        nbytes = 0
        eps = 0.0
        if do_sync:
            fsync, eps = sub.average_stacked(models)
            if topology == "coordinator":
                nbytes, ledger = sub.sync_payload(models, ledger)
            else:
                nbytes = allreduce_cost(sub, x.shape[0])
            models = sub.adopt(models, fsync)
            reference = fsync
            state = sub.with_models(state, models)
        div = sub.divergence(models) if record else 0.0
        return (state, reference, ledger), (losses, err, nbytes, div,
                                             do_sync, eps)

    return step


def init_protocol_carry(sub: Substrate, m: int, device):
    """Round-0 state: blank stacked learners, the compressed average of
    those blank models as the first reference, and an empty ledger."""
    state0 = sub.init(m, device)
    ref0, _ = sub.average_stacked(sub.models_of(state0))
    return state0, ref0, sub.ledger_init(m, device)


def assemble_sim_result(sub: Substrate, record_divergence: bool,
                        loss: np.ndarray, err: np.ndarray,
                        round_bytes: np.ndarray, div: np.ndarray,
                        flags: np.ndarray, eps: np.ndarray) -> SimResult:
    """Host-side post-processing: the cross-learner sums of the (T, m)
    float32 series (numpy's pairwise sum, as the reference's), then the
    float64/int64 accumulation of ``SimResult.from_round_series``."""
    keep_div = record_divergence or sub.free_divergence
    return SimResult.from_round_series(
        loss.sum(axis=1), err.sum(axis=1), round_bytes,
        div if keep_div else np.zeros((0,)),
        flags,
        eps if sub.has_eps else np.zeros((0,)))


def run(
    learner: LearnerLike,
    pcfg: ProtocolConfig,
    X: np.ndarray,          # (T, m, d)
    Y: np.ndarray,          # (T, m)
    *,
    sync_budget: Optional[int] = None,
    compress_method: Optional[str] = None,
    record_divergence: bool = False,
    backend: Optional[str] = None,
    mesh=None,
    topology: str = "coordinator",
    participation: Optional[np.ndarray] = None,
    device=None,
) -> SimResult:
    """Run T rounds of m learners under ``pcfg`` on ``device`` (default
    the CUDA card; ``device="cpu"`` runs the plain versions).

    ``learner``, ``sync_budget``, ``compress_method``, ``backend`` and
    ``topology`` mean what they mean in the reference's ``engine.run``;
    ``backend="kernels"`` is the counterpart of its ``"pallas"``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "engine.run(mesh=...) is the mesh engine, ROADMAP.md "
            "'Mesh engine' (not ported yet)")
    if participation is not None:
        raise NotImplementedError(
            "engine.run(participation=...) is the population layer, "
            "ROADMAP.md 'population/' (not ported yet)")
    if pcfg.kind not in PROTOCOL_KIND_CODES:
        raise ValueError(f"unknown protocol kind {pcfg.kind!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {TOPOLOGIES}")
    dev = device_mod.resolve(device)
    sub = substrate_mod.substrate_of(
        learner, sync_budget=sync_budget, compress_method=compress_method,
        backend=backend)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    sub.validate(T, m, d)
    if topology == "allreduce":
        allreduce_cost(sub, m)      # refuse an int32 overflow up front
    sub = sub.on(dev)
    record = bool(record_divergence) or sub.free_divergence
    step = make_protocol_step(sub, pcfg.kind,
                              record_divergence=record_divergence,
                              topology=topology)
    params = params_of(pcfg)

    Xd = torch.as_tensor(X, device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    loss_out = torch.zeros((T, m), dtype=torch.float32, device=dev)
    err_out = torch.zeros((T, m), dtype=torch.float32, device=dev)
    bytes_out = torch.zeros((T,), dtype=torch.int64, device=dev)
    div_out = torch.zeros((T,), dtype=torch.float32, device=dev)
    eps_out = torch.zeros((T,), dtype=torch.float32, device=dev)
    flags = np.zeros((T,), bool)

    carry = init_protocol_carry(sub, m, dev)
    for t in range(T):
        carry, (losses, err, nbytes, div, fired, eps) = step(
            params, carry, (Xd[t], Yd[t], t))
        loss_out[t] = losses
        err_out[t] = err
        if fired:
            bytes_out[t] = nbytes
            eps_out[t] = eps
            flags[t] = True
        if record:
            div_out[t] = div

    return assemble_sim_result(
        sub, bool(record_divergence), loss_out.cpu().numpy(),
        err_out.cpu().numpy(), bytes_out.cpu().numpy(),
        div_out.cpu().numpy(), flags, eps_out.cpu().numpy())


def sweep(*args, **kwargs):
    """The protocol-grid sweep is not ported yet (ROADMAP.md 'sweep')."""
    raise NotImplementedError(
        "engine.sweep is not ported yet (ROADMAP.md, first queued item "
        "after the engine.run slice)")
