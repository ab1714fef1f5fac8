"""The device-resident engine (port of ``repro/core/engine.py``).

``run`` simulates T rounds of m learners under one protocol with the
learner state, the reference model, the byte ledger and every
per-round observable on the device.  Where the reference compiles one
``lax.scan``, the port runs a Python loop over T that writes each
round's per-learner outputs into preallocated (T, m) device tensors;
the host reads them once, at the end.

One round is ``_make_shard_step``'s ``step``, the counterpart of the
reference's scan body: ``run`` iterates it, and the serving engine
(serving/engine.py) drives its one-device case,
:func:`make_protocol_step`, one labeled round at a time, so a serving
run's protocol view equals ``run``'s bitwise on the same device.

Control flow: ``lax.cond`` becomes ``if``.  Periodic syncs and the
dynamic protocol's check rounds are decided on the host from ``t``
alone; the only value that crosses to the host during a run is the
dynamic protocol's violation bit, once per check round.

``run(participation=)`` takes a (T, m) bool mask of the per-round
cohort (the population layer, ``population/``): the masked round is
the reference's masked scan body as host control flow.  A round in
which every learner takes part and none rejoins runs the unmasked step
verbatim, so an all-True mask reproduces the unmasked run bitwise.

``sweep`` runs a grid of protocol configurations.  Configs are grouped
by substrate; each group is one host loop over T with its n configs'
learners stacked on one axis of n m rows, so a round is ONE
``round_stacked`` call (one kernel launch) for the group where the
substrate's engaged round computes each row alone
(``Substrate.rows_independent``, decided on a shard's rows), and each
config's own call otherwise.  Syncs and check rounds are decided per
config on the host; the due configs' dynamic checks run as one
``quadform`` launch (``Substrate.dist_to_ref_grouped``), and each
firing config's sync runs on its own (m, ...) rows with the code
``run`` uses.  Where the
reference's ``vmap`` lowers its ``lax.cond`` to a select that pays the
sync every round, the host decides and pays only what fires.

Exactness contract against the reference engine: ``sync_rounds``,
``num_syncs`` and ``cumulative_bytes`` are equal; per-learner losses,
errors, divergences and epsilons agree within the parity tolerance;
the cross-learner sum runs on the host exactly as the reference's
``assemble_sim_result`` does.  A run is a pure function of its seeds:
no kernel or reduction on this path sums in a run-dependent order.
Inside the port, a sweep row equals its solo ``run`` bitwise on the
same device.

The mesh (``run(mesh=)`` / ``sweep(mesh=)``, the reference's
``shard_map`` engine, DESIGN.md Sec. 9): ``mesh`` is a
``launch.mesh.LearnerMesh``, a tuple of devices driven by this one
process.  The learner axis is cut into contiguous blocks, shard k's on
its own device: its state, its stream, its (T, m/n) loss and error
series and a copy of the reference.  Each shard runs its round with
its own kernel launches and its own dynamic check (the host reads one
violation bit a shard); a sync joins the shards' models in learner
order on the lead shard, runs the single-device sync there and cuts
the adopted models back.  No float is summed across shards (no
all-reduce, no partial sums), so a mesh run equals the single-device
run bitwise; the host joins the shards' series in learner order before
the cross-learner sum.  A shard engages its kernels on its own rows,
as a shard of the reference's does: where m/n falls below the launch
threshold and m does not, the shards take the plain expressions.  A
sweep on a mesh stacks a group's configs over each shard's m/n
learners (one round launch a shard a round), runs the grouped check
per shard and ORs each config's bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import device as device_mod
from ..launch import mesh as mesh_mod
from ..launch.mesh import learner_axes_of  # noqa: F401  (the reference's engine name)
from . import substrate as substrate_mod
from .learners import LearnerConfig
from .protocol import PROTOCOL_KIND_CODES, ProtocolConfig
from .rff import RFFSpec
from .simulation import SimResult
from .substrate import Substrate, tree_map

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


def _decide(kind: str, params: ScanParams, t: int) -> Optional[bool]:
    """A round's sync decision where the host knows it from ``t``
    alone; None on a dynamic check round (the distances decide)."""
    if kind == "none":
        return False
    if kind == "continuous":
        return True
    if kind == "periodic":
        return (t + 1) % params.period == 0
    return None if (t + 1) % params.mini_batch == 0 else False


def _sync(sub: Substrate, topology: str, models, ledger, m: int):
    """One synchronization of m stacked models -> (models adopting the
    new reference, the reference, bytes, ledger, eps)."""
    fsync, eps = sub.average_stacked(models)
    if topology == "coordinator":
        nbytes, ledger = sub.sync_payload(models, ledger)
    else:
        nbytes = allreduce_cost(sub, m)
    return sub.adopt(models, fsync), fsync, nbytes, ledger, eps


def _make_shard_step(subs: Sequence[Substrate], kind: str, *,
                     record_divergence: bool = False,
                     topology: str = "coordinator",
                     devices: Optional[Sequence[torch.device]] = None,
                     masked: bool = False):
    """One protocol round over the shards of a learner mesh (the
    reference's ``_make_step``, ``repro/core/engine.py:160-385``).

    ``subs[k]`` is the substrate on shard k's device ``devices[k]``
    (None: one shard, nothing moves).  ``carry = (states, refs,
    ledger)``: shard k's stacked state, its copy of the reference, and
    the one ledger on the lead shard (shard 0); ``xs = (xs, ys, t)``
    with shard k's (m/n, d) inputs and (m/n,) labels.  ``outs =
    (losses, errs, bytes, divergence, sync_flag, eps)`` with one (m/n,)
    loss and error tensor a shard; the flag is a host ``bool``; on a
    round without a sync ``bytes`` is the int 0 and ``eps`` the float
    0.0, and ``divergence`` is 0.0 unless it is recorded
    (``record_divergence`` or ``sub.free_divergence``).

    Each shard runs its round on its own device.  The dynamic check
    computes each shard's distances against its copy of the reference;
    the host reads one violation bit a shard and ORs them.  A sync
    joins the shards' models in learner order on the lead shard (the
    reference's ``all_gather``), runs the single-device sync there and
    cuts the adopted models back into the shards; the divergence is
    the lead's over the joined models.  No float is summed across
    shards, so a mesh round equals the single-device round bitwise.

    ``masked`` (the reference's masked scan body as host control flow):
    the carry gains ``prev``, the previous round's (m,) host cohort,
    and ``xs`` gains ``p``, this round's, and ``p_devs``, its slice on
    each shard's device.  Learners with ``p & ~prev`` rejoin: they
    re-adopt the reference before their round and pay
    ``rejoin_payload_bytes``.  Inactive learners keep their state and
    report zero loss and error; the dynamic check polls the cohort
    only; a sync averages, prices and adopts over the cohort and needs
    a nonempty one.  The cohort, the rejoin count and the rejoin bytes
    are integer sums over the shards.  A round in which every learner
    takes part and none rejoins is the unmasked round.
    """
    if kind not in PROTOCOL_KIND_CODES:
        raise ValueError(f"unknown protocol kind {kind!r}")
    _check_topology(topology)
    subs = list(subs)
    devices = list(devices) if devices is not None else [None] * len(subs)
    lead_sub, lead = subs[0], devices[0]
    record = bool(record_divergence) or lead_sub.free_divergence

    def on_lead(v):
        return v.to(lead) if lead is not None and torch.is_tensor(v) else v

    def violated(bits) -> bool:
        # one bit a shard read back; their OR decides
        return any([bool(b) for b in bits])

    def sync(models, ledger, m, p=None, pds=None):
        """Gather, the single-device sync on the lead, cut back ->
        (shards' models, refs, bytes, ledger, eps, joined models)."""
        full = substrate_mod.join_rows(models, lead)
        if p is None:
            full, ref, nbytes, ledger, eps = _sync(lead_sub, topology, full,
                                                   ledger, m)
        else:
            pd = substrate_mod.join_rows(pds, lead)
            ref, eps = lead_sub.average_stacked_masked(full, p)
            if topology == "coordinator":
                nbytes, ledger = lead_sub.sync_payload_masked(full, p, ledger)
            else:
                allreduce_cost(lead_sub, m)       # the full-m guard
                nbytes = lead_sub.allreduce_sync_bytes_masked(int(p.sum()))
            # only the cohort adopts; the others keep their stale model
            full = _tree_where(pd, lead_sub.adopt(full, ref), full)
        return (substrate_mod.shard_rows(full, devices),
                substrate_mod.replicate(ref, devices), nbytes, ledger, eps,
                full)

    def rounds(states, xs, ys):
        out = [sub.round_stacked(st, (x, y))
               for sub, st, x, y in zip(subs, states, xs, ys)]
        return ([o[0] for o in out], [o[1] for o in out],
                [_err_terms(sub.loss, o[2], y)
                 for sub, o, y in zip(subs, out, ys)])

    def finish(states, models, refs, ledger, losses, errs, nbytes, fired,
               eps, full):
        states = [sub.with_models(st, mo)
                  for sub, st, mo in zip(subs, states, models)]
        if record:
            if full is None:
                full = substrate_mod.join_rows(models, lead)
            div = lead_sub.divergence(full)
        else:
            div = 0.0
        return (states, refs, ledger), (losses, errs, nbytes, div, fired,
                                        eps)

    def step(params: ScanParams, carry, xs):
        states, refs, ledger = carry
        xs_, ys, t = xs
        states, losses, errs = rounds(states, xs_, ys)
        models = [sub.models_of(st) for sub, st in zip(subs, states)]

        do_sync = _decide(kind, params, t)
        if do_sync is None:     # dynamic: check the local conditions
            do_sync = violated([
                torch.any(sub.dist_to_ref(mo, r) > params.delta)
                for sub, mo, r in zip(subs, models, refs)])
        nbytes = 0
        eps = 0.0
        full = None
        if do_sync:
            m = sum(int(x.shape[0]) for x in xs_)
            models, refs, nbytes, ledger, eps, full = sync(models, ledger, m)
        return finish(states, models, refs, ledger, losses, errs, nbytes,
                      do_sync, eps, full)

    if not masked:
        return step

    def masked_step(params: ScanParams, carry, xs):
        states, refs, ledger, prev = carry
        xs_, ys, t, p, pds = xs
        m = p.shape[0]
        rows = m // len(subs)
        cut = [slice(k * rows, (k + 1) * rows) for k in range(len(subs))]
        rejoin = p & ~prev
        cohort = sum(int(p[c].sum()) for c in cut)
        n_rejoin = sum(int(rejoin[c].sum()) for c in cut)
        if cohort == m and n_rejoin == 0:
            carry, outs = step(params, (states, refs, ledger), (xs_, ys, t))
            return carry + (p,), outs

        states = list(states)
        rejoin_bytes = 0
        for k, (sub, c) in enumerate(zip(subs, cut)):
            if not rejoin[c].any():
                continue
            mo = sub.models_of(states[k])
            rejoin_bytes = rejoin_bytes + on_lead(
                sub.rejoin_payload_bytes(mo, refs[k], rejoin[c]))
            states[k] = sub.with_models(states[k], _tree_where(
                torch.as_tensor(rejoin[c], device=xs_[k].device),
                sub.adopt(mo, refs[k]), mo))
        pre = states
        states, losses, errs = rounds(states, xs_, ys)
        if cohort < m:
            states = [_tree_where(pd, st, st0)
                      for pd, st, st0 in zip(pds, states, pre)]
            losses = [torch.where(pd, lo, torch.zeros_like(lo))
                      for pd, lo in zip(pds, losses)]
            errs = [torch.where(pd, er, torch.zeros_like(er))
                    for pd, er in zip(pds, errs)]
        models = [sub.models_of(st) for sub, st in zip(subs, states)]

        do_sync = cohort > 0 and _decide(kind, params, t) is not False
        if do_sync and kind == "dynamic":
            do_sync = violated([
                torch.any(pd & (sub.dist_to_ref(mo, r) > params.delta))
                for sub, mo, r, pd in zip(subs, models, refs, pds)])
        nbytes = 0
        eps = 0.0
        full = None
        if do_sync:
            models, refs, nbytes, ledger, eps, full = sync(
                models, ledger, m, p, pds)
        carry, outs = finish(states, models, refs, ledger, losses, errs,
                             nbytes + rejoin_bytes, do_sync, eps, full)
        return carry + (p,), outs

    return masked_step


def make_protocol_step(sub: Substrate, kind: str, *,
                       record_divergence: bool = False,
                       topology: str = "coordinator"):
    """One protocol round on one device — the body ``run`` iterates.

    Returns ``step(params, carry, xs) -> (carry, outs)`` with
    ``carry = (stacked learner state, reference, ledger)``,
    ``xs = (x (m, d), y (m,), t int)`` and
    ``outs = (loss (m,), err (m,), bytes, divergence, sync_flag, eps)``.
    The flag is a host ``bool``; on a round without a sync ``bytes`` is
    the int 0 and ``eps`` the float 0.0, and ``divergence`` is 0.0
    unless it is recorded (``record_divergence`` or
    ``sub.free_divergence``).  Everything else stays on the device.
    It is the one-shard case of the mesh's round, the same code.
    """
    inner = _make_shard_step([sub], kind,
                             record_divergence=record_divergence,
                             topology=topology)

    def step(params: ScanParams, carry, xs):
        state, reference, ledger = carry
        x, y, t = xs
        (states, refs, ledger), (losses, errs, *rest) = inner(
            params, ([state], [reference], ledger), ([x], [y], t))
        return (states[0], refs[0], ledger), (losses[0], errs[0], *rest)

    return step


def _tree_where(mask: torch.Tensor, new, old):
    """Per-learner select over a stacked tree: ``new`` where ``mask``
    (m,) is True, ``old`` elsewhere."""
    return tree_map(lambda a, b: torch.where(
        mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b), new, old)


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


def shard_devices(mesh, m: int, device=None) -> Tuple[torch.device, ...]:
    """The devices a run of m learners puts its shards on: the mesh's
    (the reference's ``_resolve_mesh``), or the one resolved ``device``
    without a mesh.  Refuses a mesh that is not a
    ``launch.mesh.LearnerMesh`` (TypeError), an m that does not divide
    evenly over its shards, and a ``device`` other than the mesh's lead
    device (ValueError)."""
    if mesh is None:
        return (device_mod.resolve(device),)
    if not isinstance(mesh, mesh_mod.LearnerMesh):
        raise TypeError(
            f"mesh must be a launch.mesh.LearnerMesh "
            f"(make_learner_mesh), got {type(mesh).__name__}")
    axes = mesh_mod.learner_axes_of(mesh)
    n = mesh_mod.num_learners(mesh)
    if m % n:
        raise ValueError(
            f"{m} learners cannot shard evenly over {n} devices "
            f"(mesh axes {axes})")
    devices = tuple(mesh_mod.resolve_device(d) for d in mesh.devices)
    if device is not None and mesh_mod.resolve_device(device) != devices[0]:
        raise ValueError(f"device={device} disagrees with the mesh, whose "
                         f"lead device is {devices[0]}")
    return devices


def _shard_columns(a: np.ndarray, devices, axis: int = 1) -> list:
    """A host array's learner axis cut into one contiguous block a
    shard, each on its shard's device."""
    parts = np.split(a, len(devices), axis=axis)
    return [torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for v, dev in zip(parts, devices)]


def _check_topology(topology: str) -> None:
    if topology not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topology!r}; expected one of {TOPOLOGIES}")


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
    ``mesh``: a ``launch.mesh.LearnerMesh`` to shard the learner axis
    over (m must divide evenly; ``device``, if given, must be its lead
    device); the result equals the single-device run's bitwise.
    ``participation``: a (T, m) bool mask of each round's cohort
    (``_make_shard_step``'s masked round); None and an all-True mask
    give the same result bitwise.
    """
    if pcfg.kind not in PROTOCOL_KIND_CODES:
        raise ValueError(f"unknown protocol kind {pcfg.kind!r}")
    _check_topology(topology)
    sub = substrate_mod.substrate_of(
        learner, sync_budget=sync_budget, compress_method=compress_method,
        backend=backend)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    sub.validate(T, m, d)
    devices = shard_devices(mesh, m, device)
    if participation is not None:
        part = np.asarray(participation).astype(bool)
        if part.shape != (T, m):
            raise ValueError(
                f"participation shape {part.shape} != (T, m) = {(T, m)}")
    if topology == "allreduce":
        allreduce_cost(sub, m)      # refuse an int32 overflow up front
    lead = devices[0]
    subs = [sub.on(dev) for dev in devices]
    record = bool(record_divergence) or sub.free_divergence
    params = params_of(pcfg)

    Xd = _shard_columns(X, devices)
    Yd = _shard_columns(Y, devices)
    loss_out = [torch.zeros(y.shape, dtype=torch.float32, device=y.device)
                for y in Yd]
    err_out = [torch.zeros_like(lo) for lo in loss_out]
    bytes_out = torch.zeros((T,), dtype=torch.int64, device=lead)
    div_out = torch.zeros((T,), dtype=torch.float32, device=lead)
    eps_out = torch.zeros((T,), dtype=torch.float32, device=lead)
    flags = np.zeros((T,), bool)

    # the whole stack initialized and cut: learner ids stay global
    state0, ref0, ledger0 = init_protocol_carry(subs[0], m, lead)
    carry = (substrate_mod.shard_rows(state0, devices),
             substrate_mod.replicate(ref0, devices), ledger0)
    step = _make_shard_step(subs, pcfg.kind,
                            record_divergence=record_divergence,
                            topology=topology, devices=devices,
                            masked=participation is not None)
    if participation is None:
        rows = (([x[t] for x in Xd], [y[t] for y in Yd], t)
                for t in range(T))
    else:
        # prev starts as round 0's mask: nobody rejoins into the blank
        # reference every learner starts from
        carry = carry + (part[0],)
        part_d = _shard_columns(part, devices)
        rows = (([x[t] for x in Xd], [y[t] for y in Yd], t, part[t],
                 [pd[t] for pd in part_d]) for t in range(T))
    for t, xs in enumerate(rows):
        carry, (losses, errs, nbytes, div, fired, eps) = step(params, carry,
                                                              xs)
        for lo, er, lo_t, er_t in zip(loss_out, err_out, losses, errs):
            lo[t] = lo_t
            er[t] = er_t
        if fired or torch.is_tensor(nbytes) or nbytes:
            bytes_out[t] = nbytes
        if fired:
            eps_out[t] = eps
            flags[t] = True
        if record:
            div_out[t] = div

    # the shards' (T, m/n) series joined in learner order on the host
    return assemble_sim_result(
        sub, bool(record_divergence),
        np.concatenate([lo.cpu().numpy() for lo in loss_out], axis=1),
        np.concatenate([er.cpu().numpy() for er in err_out], axis=1),
        bytes_out.cpu().numpy(), div_out.cpu().numpy(), flags,
        eps_out.cpu().numpy())


@dataclasses.dataclass
class SweepResult:
    """Stacked per-round series of a protocol-grid sweep.

    Every array carries a leading axis of size n = len(configs);
    ``sweep_result[i]`` materializes the i-th configuration as a
    regular ``SimResult``.
    """

    configs: List[ProtocolConfig]
    losses: np.ndarray        # (n, T)
    errors: np.ndarray        # (n, T)
    round_bytes: np.ndarray   # (n, T)
    sync_flags: np.ndarray    # (n, T) bool
    divergences: Optional[np.ndarray]  # (n, T) or None (not recorded)
    eps: Optional[np.ndarray]          # (n, T) or None (eps-free substrates)

    def __len__(self) -> int:
        return len(self.configs)

    def __getitem__(self, i: int) -> SimResult:
        return SimResult.from_round_series(
            self.losses[i], self.errors[i], self.round_bytes[i],
            self.divergences[i] if self.divergences is not None
            else np.zeros((0,)),
            self.sync_flags[i],
            self.eps[i] if self.eps is not None else np.zeros((0,)))

    @property
    def results(self) -> List[SimResult]:
        return [self[i] for i in range(len(self))]


def _rows_of(tree, c: int, m: int):
    """Config c's (m, ...) rows of a stacked tree, as fresh tensors (the
    solo run's reductions see allocations of their own too)."""
    return tree_map(lambda v: v[c * m:(c + 1) * m].clone(), tree)


def _set_rows(tree, c: int, m: int, rows) -> None:
    tree_map(lambda v, r: v[c * m:(c + 1) * m].copy_(r), tree, rows)


def _sweep_group(subs: Sequence[Substrate], pcfgs: Sequence[ProtocolConfig],
                 Xs: Sequence[list], Ys: Sequence[list], record: bool,
                 topology: str, devices: Sequence[torch.device]):
    """One substrate's configs over T rounds (see the module docstring),
    ``subs[k]`` the substrate on shard k's device and ``Xs[c][k]``
    config c's (T, m/n, d) stream of shard k -> (loss (n, T, m),
    err (n, T, m), bytes (n, T), div (n, T), flags (n, T),
    eps (n, T)) as host arrays."""
    n, S = len(pcfgs), len(devices)
    T, r = Ys[0][0].shape
    m = S * r
    sub, lead = subs[0], devices[0]
    params = [params_of(p) for p in pcfgs]
    # a shard's round engages on its own rows, as the shard's run does
    stacked = sub.rows_independent(r)
    loss_out = [torch.zeros((n, T, r), dtype=torch.float32, device=dev)
                for dev in devices]
    err_out = [torch.zeros_like(lo) for lo in loss_out]
    bytes_out = torch.zeros((n, T), dtype=torch.int64, device=lead)
    div_out = torch.zeros((n, T), dtype=torch.float32, device=lead)
    eps_out = torch.zeros((n, T), dtype=torch.float32, device=lead)
    flags = np.zeros((n, T), bool)

    carries = [init_protocol_carry(sub, m, lead) for _ in range(n)]
    refs = [substrate_mod.replicate(c[1], devices) for c in carries]
    ledgers = [c[2] for c in carries]
    states = [substrate_mod.shard_rows(c[0], devices) for c in carries]
    if stacked:     # one state of n m/n rows a shard
        state = [tree_map(lambda *v: torch.cat(v),
                          *(states[c][k] for c in range(n)))
                 for k in range(S)]

    def models_of(c):
        if stacked:
            return [_rows_of(subs[k].models_of(state[k]), c, r)
                    for k in range(S)]
        return [subs[k].models_of(states[c][k]) for k in range(S)]

    for t in range(T):
        for k in range(S):
            if stacked:
                x = torch.cat([X[k][t] for X in Xs])
                y = torch.cat([Y[k][t] for Y in Ys])
                state[k], losses, yhat = subs[k].round_stacked(state[k],
                                                               (x, y))
                loss_out[k][:, t] = losses.view(n, r)
                err_out[k][:, t] = _err_terms(sub.loss, yhat, y).view(n, r)
            else:
                for c in range(n):
                    y = Ys[c][k][t]
                    states[c][k], losses, yhat = subs[k].round_stacked(
                        states[c][k], (Xs[c][k][t], y))
                    loss_out[k][c, t] = losses
                    err_out[k][c, t] = _err_terms(sub.loss, yhat, y)

        fire = [_decide(p.kind, prm, t) for p, prm in zip(pcfgs, params)]
        due = [c for c in range(n) if fire[c] is None]
        models = {}
        if due:
            models.update((c, models_of(c)) for c in due)
            bits = []       # a shard's bit for each due config
            for k in range(S):
                dists = subs[k].dist_to_ref_grouped(
                    [models[c][k] for c in due], [refs[c][k] for c in due])
                bits.append(torch.stack([
                    torch.any(dist > params[c].delta)
                    for dist, c in zip(dists, due)]))
            bits = [b.tolist() for b in bits]
            for i, c in enumerate(due):
                fire[c] = any(b[i] for b in bits)
        for c in range(n):
            if fire[c]:
                full = substrate_mod.join_rows(
                    models[c] if c in models else models_of(c), lead)
                full, ref, nbytes, ledgers[c], eps = _sync(
                    sub, topology, full, ledgers[c], m)
                mc = substrate_mod.shard_rows(full, devices)
                refs[c] = substrate_mod.replicate(ref, devices)
                models[c] = mc
                for k in range(S):
                    if stacked:
                        _set_rows(subs[k].models_of(state[k]), c, r, mc[k])
                    else:
                        states[c][k] = subs[k].with_models(states[c][k],
                                                           mc[k])
                bytes_out[c, t] = nbytes
                eps_out[c, t] = eps
                flags[c, t] = True
            if record:
                div_out[c, t] = sub.divergence(substrate_mod.join_rows(
                    models[c] if c in models else models_of(c), lead))

    def joined(outs):       # the shards' learners in order
        return np.concatenate([o.cpu().numpy() for o in outs], axis=2)

    return (joined(loss_out), joined(err_out), bytes_out.cpu().numpy(),
            div_out.cpu().numpy(), flags, eps_out.cpu().numpy())


def sweep(
    learner: Union[LearnerLike, Sequence[LearnerLike]],
    pcfgs: Sequence[ProtocolConfig],
    X: np.ndarray,          # (T, m, d) shared, or (n, T, m, d) per config
    Y: np.ndarray,          # (T, m) shared, or (n, T, m)
    *,
    sync_budget: Optional[int] = None,
    compress_method: Optional[str] = None,
    record_divergence: bool = False,
    backend: Optional[str] = None,
    mesh=None,
    topology: str = "coordinator",
    device=None,
) -> SweepResult:
    """Simulate a grid of protocol configurations (the reference's
    ``engine.sweep``; see the module docstring for how the port runs
    it), on ``device`` (default the CUDA card).

    ``learner`` may be a sequence of per-config substrates (same length
    as ``pcfgs``) for mixed-substrate grids; X with a leading config
    axis gives every config its own stream.  The other keywords mean
    what they mean in :func:`run`.  Row i equals ``run(learner_i,
    pcfgs[i], X_i, Y_i)`` on the same device bitwise.
    """
    pcfgs = list(pcfgs)
    n = len(pcfgs)
    if n == 0:
        raise ValueError("sweep needs at least one ProtocolConfig")
    for p in pcfgs:
        if p.kind not in PROTOCOL_KIND_CODES:
            raise ValueError(f"unknown protocol kind {p.kind!r}")
    _check_topology(topology)
    kw = dict(sync_budget=sync_budget, compress_method=compress_method,
              backend=backend)
    if isinstance(learner, (list, tuple)):
        if len(learner) != n:
            raise ValueError(
                f"{len(learner)} substrates != {n} protocol configs")
        subs = [substrate_mod.substrate_of(s, **kw) for s in learner]
    else:
        subs = [substrate_mod.substrate_of(learner, **kw)] * n
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    data_batched = X.ndim == 4
    if data_batched and X.shape[0] != n:
        raise ValueError(
            f"per-config data axis {X.shape[0]} != n_configs {n}")
    T, m, d = X.shape[-3:]
    groups: dict = {}
    for i, sub in enumerate(subs):
        groups.setdefault(sub, []).append(i)
    for sub in groups:
        sub.validate(T, m, d)
        if topology == "allreduce":
            allreduce_cost(sub, m)
    devices = shard_devices(mesh, m, device)
    if data_batched:
        Xs = [_shard_columns(X[i], devices) for i in range(n)]
        Ys = [_shard_columns(Y[i], devices) for i in range(n)]
    else:
        Xs = [_shard_columns(X, devices)] * n
        Ys = [_shard_columns(Y, devices)] * n

    losses = np.zeros((n, T), np.float32)
    errors = np.zeros((n, T), np.float32)
    round_bytes = np.zeros((n, T), np.int64)
    flags = np.zeros((n, T), bool)
    divs = np.zeros((n, T), np.float32)
    eps = np.zeros((n, T), np.float32)
    for sub, idx in groups.items():
        lo, er, nb, dv, fl, ep = _sweep_group(
            [sub.on(dev) for dev in devices], [pcfgs[i] for i in idx],
            [Xs[i] for i in idx], [Ys[i] for i in idx],
            bool(record_divergence) or sub.free_divergence, topology,
            devices)
        for k, i in enumerate(idx):
            # (T, m) per-learner series summed as run sums them
            losses[i], errors[i] = lo[k].sum(axis=1), er[k].sum(axis=1)
            round_bytes[i], divs[i], flags[i], eps[i] = nb[k], dv[k], \
                fl[k], ep[k]

    keep_div = record_divergence or all(s.free_divergence for s in subs)
    keep_eps = any(s.has_eps for s in subs)
    return SweepResult(
        configs=pcfgs,
        losses=losses,
        errors=errors,
        round_bytes=round_bytes,
        sync_flags=flags,
        divergences=divs if keep_div else None,
        eps=eps if keep_eps else None,
    )
