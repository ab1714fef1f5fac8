"""Distributed online learning protocols (port of ``repro/core/protocol.py``).

A protocol Pi = (A, sigma) runs an online learning algorithm A on m
local learners and synchronizes their models with an operator sigma.
The operators work on **stacked-learner pytrees**: dicts, lists,
tuples and NamedTuples of tensors whose every leaf carries a leading
learner axis of size m.

- ``sigma_continuous``: average every round (sigma_1).
- ``sigma_periodic``:   average every b rounds (sigma_b).
- ``sigma_dynamic``:    average only when a local condition
  ``||f_i - r||^2 <= Delta`` against the reference model r is violated.

Where the reference traces ``lax.cond``, the port decides on the host:
the round counter and the violation bit each cross to the host once a
round.  No operator writes in place, so a synced stack and a stacked
reference may be broadcast views of one average.

Every comparison that decides a sync is made as the reference makes it
(the rounding of each side is part of the ledger): distances upcast
each leaf to float32 before the difference, thresholds are float32
tensors, and a sync's charge is converted once on the host to a
float32 scalar before ``flag * charge`` meets the float32 carry.  The
reference multiplies by a weak int32 there, which is exact below 2^31
bytes and raises above it (ROADMAP.md, Faults); the port carries on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves, tree_map

PyTree = Any

# Stable integer codes for the protocol kinds.
PROTOCOL_KIND_CODES = {"none": 0, "continuous": 1, "periodic": 2, "dynamic": 3}

# the adaptive multiplier's bounds, as float32 values
_SCALE_MIN = float(np.float32(1e-9))
_SCALE_MAX = float(np.float32(1e12))


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Configuration of a distributed online learning protocol.

    kind: ``none | continuous | periodic | dynamic``; ``period`` is the
    periodic protocol's b, ``delta`` the dynamic protocol's threshold
    Delta, ``mini_batch`` how often (in rounds) the dynamic protocol
    checks its local conditions.  ``per_group`` splits Delta over the
    top-level parameter groups by their sizes.  ``delta_schedule``:
    ``const`` (Delta_t = delta), ``sqrt`` (delta / sqrt(t)) or
    ``adaptive`` (a multiplier raised by ``adapt_up`` on every sync and
    lowered while quiet, so the sync rate settles at
    ``target_sync_rate``).  ``engine.run`` reads none of the last four.
    """

    kind: str = "dynamic"
    period: int = 1
    delta: float = 0.1
    mini_batch: int = 1
    per_group: bool = False
    delta_schedule: str = "const"
    target_sync_rate: float = 0.05
    adapt_up: float = 1.25

    def __post_init__(self) -> None:
        if self.kind not in PROTOCOL_KIND_CODES:
            raise ValueError(f"unknown protocol kind: {self.kind!r}")
        if self.period < 1:
            raise ValueError("period must be >= 1")
        if self.delta < 0:
            raise ValueError("delta must be >= 0")
        if self.delta_schedule not in ("const", "sqrt", "adaptive"):
            raise ValueError(self.delta_schedule)
        if not (0.0 < self.target_sync_rate < 1.0):
            raise ValueError("target_sync_rate in (0, 1)")

    @property
    def kind_code(self) -> int:
        """Integer code of ``kind`` (see PROTOCOL_KIND_CODES)."""
        return PROTOCOL_KIND_CODES[self.kind]


class ProtocolState(NamedTuple):
    """Carry of a protocol between rounds.

    reference: the reference model r_t (stacked or un-stacked pytree);
    step (int32): round counter t; syncs (int32): V(t); bytes_sent
    (float32): C(t) in bytes, coordinator topology; last_divergence
    (float32): the divergence of the latest round; delta_scale
    (float32): the adaptive threshold's multiplier, a neutral Python
    1.0 in a state built without it."""

    reference: PyTree
    step: torch.Tensor
    syncs: torch.Tensor
    bytes_sent: torch.Tensor
    last_divergence: torch.Tensor
    delta_scale: Any = 1.0


# ---------------------------------------------------------------------------
# Stacked-pytree helpers
# ---------------------------------------------------------------------------


def _num_learners(stacked: PyTree) -> int:
    return leaves(stacked)[0].shape[0]


def _device_of(tree: PyTree) -> torch.device:
    return leaves(tree)[0].device


def average_model(stacked: PyTree) -> PyTree:
    """fbar = 1/m sum_i f_i: the sum over the learner axis in float32,
    divided by m, in the leaf's dtype (``jnp.mean``'s order)."""
    def mean(x):
        return x.sum(0, dtype=torch.float32).div_(x.shape[0]).to(x.dtype)
    return tree_map(mean, stacked)


def broadcast_model(model: PyTree, m: int) -> PyTree:
    """An un-stacked model as a stacked configuration (broadcast views)."""
    return tree_map(lambda x: x[None].expand((m,) + tuple(x.shape)), model)


def _sq_dist_to(stacked: PyTree, ref: PyTree) -> torch.Tensor:
    """Per-learner ||f_i - r||^2, shape (m,), float32.  ``ref`` may be
    un-stacked (broadcast over the learner axis) or stacked."""
    def per_leaf(x, r):
        # float32 x - float32 r: r is widened inside the subtraction
        d = x.to(torch.float32, copy=True)
        d.sub_(r if r.dim() == x.dim() else r[None])
        d.mul_(d)
        return d.sum(dim=tuple(range(1, d.dim()))) if d.dim() > 1 else d
    return sum(leaves(tree_map(per_leaf, stacked, ref)))


def divergence(stacked: PyTree, fbar: Optional[PyTree] = None) -> torch.Tensor:
    """delta(f) = 1/m sum_i ||f_i - fbar||^2 (Eq. 1); ``fbar`` may be
    passed when the caller has it."""
    if fbar is None:
        fbar = average_model(stacked)
    return torch.mean(_sq_dist_to(stacked, fbar))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def group_local_conditions(stacked: PyTree, reference: PyTree,
                           delta) -> torch.Tensor:
    """Per-group local conditions (``per_group=True``): Delta split over
    the top-level groups in proportion to their parameter counts; a
    learner violates if any group's distance exceeds its share.
    Returns per-learner flags, shape (m,)."""
    if isinstance(stacked, dict):
        groups = [(stacked[k], reference[k]) for k in stacked]
    else:
        groups = list(zip(leaves(stacked), leaves(reference)))
    total = sum(model_num_params(g) for g, _ in groups)
    dev = _device_of(stacked)
    violated = None
    for g_s, g_r in groups:
        delta_g = delta * (model_num_params(g_s) / total)
        v = _sq_dist_to(g_s, g_r) > _f32(delta_g, dev)
        violated = v if violated is None else (violated | v)
    return violated


def local_conditions(stacked: PyTree, reference: PyTree, delta) -> torch.Tensor:
    """Per-learner violation flags of ||f_i - r||^2 <= Delta, shape (m,)."""
    return _sq_dist_to(stacked, reference) > _f32(delta, _device_of(stacked))


def model_num_params(model: PyTree) -> int:
    return sum(int(x.numel()) for x in leaves(model))


def model_bytes(model: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in leaves(model))


# ---------------------------------------------------------------------------
# Synchronization operators
# ---------------------------------------------------------------------------


def sigma_continuous(stacked: PyTree) -> PyTree:
    """sigma_1: every local model replaced by the average."""
    return broadcast_model(average_model(stacked), _num_learners(stacked))


def sigma_periodic(stacked: PyTree, step, period: int) -> PyTree:
    """sigma_b: average iff b | t, else identity."""
    return sigma_continuous(stacked) if int(step) % period == 0 else stacked


def sigma_dynamic(stacked: PyTree, reference: PyTree,
                  delta) -> Tuple[PyTree, PyTree, torch.Tensor]:
    """sigma_Delta with local-condition monitoring: a sync iff at least
    one local condition is violated.  Returns (new_stacked,
    new_reference, synced flag)."""
    any_violation = torch.any(local_conditions(stacked, reference, delta))
    if bool(any_violation):
        fbar = average_model(stacked)
        return broadcast_model(fbar, _num_learners(stacked)), fbar, any_violation
    return stacked, reference, any_violation


# ---------------------------------------------------------------------------
# Full protocol step
# ---------------------------------------------------------------------------


def init_state(model0: PyTree, m: int, *,
               stacked_reference: bool = True) -> ProtocolState:
    """All learners start at model0, r_1 = fbar_1, on model0's device.
    ``stacked_reference`` gives the reference a learner axis, as the
    LM trainer keeps it."""
    ref = broadcast_model(model0, m) if stacked_reference else model0
    dev = _device_of(model0)

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=dev)

    return ProtocolState(reference=ref, step=zero(torch.int32),
                         syncs=zero(torch.int32),
                         bytes_sent=zero(torch.float32),
                         last_divergence=zero(torch.float32),
                         delta_scale=torch.ones((), dtype=torch.float32,
                                                device=dev))


def _delta_eff(cfg: ProtocolConfig, step: int, scale, device) -> torch.Tensor:
    delta = _f32(cfg.delta, device)
    if cfg.delta_schedule == "sqrt":
        delta = delta / torch.sqrt(_f32(step, device))
    if cfg.delta_schedule == "adaptive":
        delta = delta * scale
    return delta


def _next_scale(cfg: ProtocolConfig, scale, synced: bool, device):
    """Multiplicative increase on a sync, geometric decay while quiet,
    balanced so the sync rate settles at ``target_sync_rate``."""
    if cfg.delta_schedule != "adaptive":
        return scale
    r = cfg.target_sync_rate
    factor = cfg.adapt_up if synced else cfg.adapt_up ** (-r / (1.0 - r))
    return torch.clamp(_f32(scale, device) * factor, _SCALE_MIN, _SCALE_MAX)


def apply_protocol(cfg: ProtocolConfig, stacked: PyTree, state: ProtocolState,
                   *, bytes_per_sync=None) -> Tuple[PyTree, ProtocolState]:
    """One round of the protocol's synchronization operator.

    ``bytes_per_sync`` is the cost charged for a sync; by default the
    coordinator-topology cost for dense models, 2 m |model| bytes."""
    m = _num_learners(stacked)
    dev = _device_of(stacked)
    step = int(state.step) + 1
    ref_is_stacked = leaves(state.reference)[0].dim() == leaves(stacked)[0].dim()
    if bytes_per_sync is None:
        bytes_per_sync = 2 * m * model_bytes(tree_map(lambda x: x[0], stacked))
    charge = (bytes_per_sync.to(device=dev, dtype=torch.float32)
              if torch.is_tensor(bytes_per_sync)
              else _f32(np.float32(bytes_per_sync), dev))
    step_t = state.step + 1
    fbar = average_model(stacked)
    div = divergence(stacked, fbar)

    if cfg.kind == "none":
        return stacked, state._replace(step=step_t, last_divergence=div)

    if cfg.kind == "continuous":
        synced = True
    elif cfg.kind == "periodic":
        synced = step % cfg.period == 0
    else:
        scale = state.delta_scale
        synced = False
        if step % cfg.mini_batch == 0:
            delta = _delta_eff(cfg, step, scale, dev)
            conditions = group_local_conditions if cfg.per_group \
                else local_conditions
            synced = bool(torch.any(conditions(stacked, state.reference,
                                               delta)))
    flag = torch.tensor(synced, device=dev)
    if synced:
        out = broadcast_model(fbar, m)
        reference = out if ref_is_stacked else fbar
    else:
        out, reference = stacked, state.reference
    bytes_sent = (state.bytes_sent + charge if cfg.kind == "continuous"
                  else state.bytes_sent + flag * charge)
    new_scale = (_next_scale(cfg, state.delta_scale, synced, dev)
                 if cfg.kind == "dynamic" else state.delta_scale)
    return out, ProtocolState(
        reference=reference, step=step_t,
        syncs=state.syncs + flag.to(torch.int32),
        bytes_sent=bytes_sent, last_divergence=div, delta_scale=new_scale)


def make_protocol_step(cfg: ProtocolConfig,
                       local_update: Callable[[PyTree, Any], Tuple[PyTree, torch.Tensor]]):
    """A full protocol round f_{t+1} = sigma(phi(f_t)):
    ``local_update(model_i, example_i) -> (new_model_i, loss_i)`` runs
    at each learner under ``torch.func.vmap``; the step returns
    ``(stacked, state, summed loss)``."""
    vupdate = torch.func.vmap(local_update)

    def step(stacked, state, batch):
        new_stacked, losses = vupdate(stacked, batch)
        out, new_state = apply_protocol(cfg, new_stacked, state)
        return out, new_state, torch.sum(losses)

    return step

