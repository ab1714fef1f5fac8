"""The device-resident engine (port of ``repro/core/engine.py``).

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

``run(participation=)`` takes a (T, m) bool mask of the per-round
cohort (the population layer, ``population/``): :func:`make_masked_step`
is the reference's masked scan body as host control flow.  A round in
which every learner takes part and none rejoins runs the unmasked step
verbatim, so an all-True mask reproduces the unmasked run bitwise.

``sweep`` runs a grid of protocol configurations.  Configs are grouped
by substrate; each group is one host loop over T with its n configs'
learners stacked on one axis of n m rows, so a round is ONE
``round_stacked`` call (one kernel launch) for the group where the
substrate's engaged round computes each row alone
(``Substrate.rows_independent``), and each config's own call
otherwise.  Syncs and check rounds are decided per config on the host;
the due configs' dynamic checks run as one ``quadform`` launch
(``Substrate.dist_to_ref_grouped``), and each firing config's sync
runs on its own (m, ...) rows with the code ``run`` uses.  Where the
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

Single device only: ``mesh=`` waits for the mesh engine (ROADMAP.md)
and raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Union

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

        do_sync = _decide(kind, params, t)
        if do_sync is None:     # dynamic: check the local conditions
            do_sync = bool(torch.any(
                sub.dist_to_ref(models, reference) > params.delta))

        nbytes = 0
        eps = 0.0
        if do_sync:
            models, reference, nbytes, ledger, eps = _sync(
                sub, topology, models, ledger, x.shape[0])
            state = sub.with_models(state, models)
        div = sub.divergence(models) if record else 0.0
        return (state, reference, ledger), (losses, err, nbytes, div,
                                             do_sync, eps)

    return step


def _tree_map(fn, *trees):
    """``fn`` over the tensors of (nested) NamedTuple trees."""
    if torch.is_tensor(trees[0]):
        return fn(*trees)
    return type(trees[0])(*(_tree_map(fn, *leaves)
                            for leaves in zip(*trees)))


def _tree_where(mask: torch.Tensor, new, old):
    """Per-learner select over a stacked tree: ``new`` where ``mask``
    (m,) is True, ``old`` elsewhere."""
    return _tree_map(lambda a, b: torch.where(
        mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b), new, old)


def make_masked_step(sub: Substrate, kind: str, *,
                     record_divergence: bool = False,
                     topology: str = "coordinator"):
    """The round of a run under a participation mask (the reference's
    masked scan body, ``repro/core/engine.py:160-385``).

    ``carry = (state, reference, ledger, prev)`` and
    ``xs = (x, y, t, p, p_dev)``: ``p`` the round's (m,) bool cohort on
    the host, ``p_dev`` the same on the device, ``prev`` the previous
    round's ``p`` (round 0's own mask at the start).  Learners with
    ``p & ~prev`` rejoin: they re-adopt the reference before their
    round and pay ``rejoin_payload_bytes``.  Inactive learners keep
    their state and report zero loss and error; the dynamic check polls
    the cohort only; a sync averages, prices and adopts over the cohort
    and needs a nonempty one.  ``outs`` are ``make_protocol_step``'s,
    the rejoin bytes added to the round's bytes.  A round in which
    every learner takes part and none rejoins is the unmasked step.
    """
    plain = make_protocol_step(sub, kind, record_divergence=record_divergence,
                               topology=topology)
    record = bool(record_divergence) or sub.free_divergence

    def step(params: ScanParams, carry, xs):
        state, reference, ledger, prev = carry
        x, y, t, p, pd = xs
        m = p.shape[0]
        rejoin = p & ~prev
        cohort, n_rejoin = int(p.sum()), int(rejoin.sum())
        if cohort == m and n_rejoin == 0:
            carry, outs = plain(params, (state, reference, ledger), (x, y, t))
            return carry + (p,), outs

        rejoin_bytes = 0
        if n_rejoin:
            models = sub.models_of(state)
            rejoin_bytes = sub.rejoin_payload_bytes(models, reference, rejoin)
            state = sub.with_models(state, _tree_where(
                torch.as_tensor(rejoin, device=x.device),
                sub.adopt(models, reference), models))
        pre = state
        state, losses, yhat = sub.round_stacked(state, (x, y))
        err = _err_terms(sub.loss, yhat, y)
        if cohort < m:
            state = _tree_where(pd, state, pre)
            losses = torch.where(pd, losses, torch.zeros_like(losses))
            err = torch.where(pd, err, torch.zeros_like(err))
        models = sub.models_of(state)

        do_sync = cohort > 0 and _decide(kind, params, t) is not False
        if do_sync and kind == "dynamic":
            do_sync = bool(torch.any(
                pd & (sub.dist_to_ref(models, reference) > params.delta)))
        nbytes = 0
        eps = 0.0
        if do_sync:
            fsync, eps = sub.average_stacked_masked(models, p)
            if topology == "coordinator":
                nbytes, ledger = sub.sync_payload_masked(models, p, ledger)
            else:
                allreduce_cost(sub, m)       # the full-m guard
                nbytes = sub.allreduce_sync_bytes_masked(cohort)
            # only the cohort adopts; the others keep their stale model
            models = _tree_where(pd, sub.adopt(models, fsync), models)
            reference = fsync
            state = sub.with_models(state, models)
        div = sub.divergence(models) if record else 0.0
        return (state, reference, ledger, p), (
            losses, err, nbytes + rejoin_bytes, div, do_sync, eps)

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


def _refuse_mesh(mesh, name: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{name}(mesh=...) is the mesh engine, ROADMAP.md "
            "'Mesh engine' (not ported yet)")


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
    ``participation``: a (T, m) bool mask of each round's cohort
    (:func:`make_masked_step`); None and an all-True mask give the same
    result bitwise.
    """
    _refuse_mesh(mesh, "engine.run")
    if pcfg.kind not in PROTOCOL_KIND_CODES:
        raise ValueError(f"unknown protocol kind {pcfg.kind!r}")
    _check_topology(topology)
    dev = device_mod.resolve(device)
    sub = substrate_mod.substrate_of(
        learner, sync_budget=sync_budget, compress_method=compress_method,
        backend=backend)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    sub.validate(T, m, d)
    if participation is not None:
        part = np.asarray(participation).astype(bool)
        if part.shape != (T, m):
            raise ValueError(
                f"participation shape {part.shape} != (T, m) = {(T, m)}")
    if topology == "allreduce":
        allreduce_cost(sub, m)      # refuse an int32 overflow up front
    sub = sub.on(dev)
    record = bool(record_divergence) or sub.free_divergence
    kw = dict(record_divergence=record_divergence, topology=topology)
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
    if participation is None:
        step = make_protocol_step(sub, pcfg.kind, **kw)
        rows = ((Xd[t], Yd[t], t) for t in range(T))
    else:
        step = make_masked_step(sub, pcfg.kind, **kw)
        # prev starts as round 0's mask: nobody rejoins into the blank
        # reference every learner starts from
        carry = carry + (part[0],)
        part_d = torch.as_tensor(part, device=dev)
        rows = ((Xd[t], Yd[t], t, part[t], part_d[t]) for t in range(T))
    for t, xs in enumerate(rows):
        carry, (losses, err, nbytes, div, fired, eps) = step(params, carry,
                                                             xs)
        loss_out[t] = losses
        err_out[t] = err
        if fired or torch.is_tensor(nbytes) or nbytes:
            bytes_out[t] = nbytes
        if fired:
            eps_out[t] = eps
            flags[t] = True
        if record:
            div_out[t] = div

    return assemble_sim_result(
        sub, bool(record_divergence), loss_out.cpu().numpy(),
        err_out.cpu().numpy(), bytes_out.cpu().numpy(),
        div_out.cpu().numpy(), flags, eps_out.cpu().numpy())


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
    return _tree_map(lambda v: v[c * m:(c + 1) * m].clone(), tree)


def _set_rows(tree, c: int, m: int, rows) -> None:
    _tree_map(lambda v, r: v[c * m:(c + 1) * m].copy_(r), tree, rows)


def _sweep_group(sub: Substrate, pcfgs: Sequence[ProtocolConfig],
                 Xs: Sequence[torch.Tensor], Ys: Sequence[torch.Tensor],
                 record: bool, topology: str, dev):
    """One substrate's configs over T rounds (see the module docstring)
    -> (loss (n, T, m), err (n, T, m), bytes (n, T), div (n, T),
    flags (n, T), eps (n, T)) as host arrays."""
    n = len(pcfgs)
    T, m = Ys[0].shape
    params = [params_of(p) for p in pcfgs]
    stacked = sub.rows_independent(m)
    loss_out = torch.zeros((n, T, m), dtype=torch.float32, device=dev)
    err_out = torch.zeros((n, T, m), dtype=torch.float32, device=dev)
    bytes_out = torch.zeros((n, T), dtype=torch.int64, device=dev)
    div_out = torch.zeros((n, T), dtype=torch.float32, device=dev)
    eps_out = torch.zeros((n, T), dtype=torch.float32, device=dev)
    flags = np.zeros((n, T), bool)

    carries = [init_protocol_carry(sub, m, dev) for _ in range(n)]
    refs = [c[1] for c in carries]
    ledgers = [c[2] for c in carries]
    if stacked:     # one state of n m rows
        state = _tree_map(lambda *v: torch.cat(v), *(c[0] for c in carries))
    else:
        states = [c[0] for c in carries]

    def models_of(c):
        if stacked:
            return _rows_of(sub.models_of(state), c, m)
        return sub.models_of(states[c])

    for t in range(T):
        if stacked:
            x = torch.cat([X[t] for X in Xs])
            y = torch.cat([Y[t] for Y in Ys])
            state, losses, yhat = sub.round_stacked(state, (x, y))
            loss_out[:, t] = losses.view(n, m)
            err_out[:, t] = _err_terms(sub.loss, yhat, y).view(n, m)
        else:
            for c in range(n):
                y = Ys[c][t]
                states[c], losses, yhat = sub.round_stacked(
                    states[c], (Xs[c][t], y))
                loss_out[c, t] = losses
                err_out[c, t] = _err_terms(sub.loss, yhat, y)

        fire = [_decide(p.kind, prm, t) for p, prm in zip(pcfgs, params)]
        due = [c for c in range(n) if fire[c] is None]
        models = {}
        if due:
            models.update((c, models_of(c)) for c in due)
            dists = sub.dist_to_ref_grouped([models[c] for c in due],
                                            [refs[c] for c in due])
            bits = torch.stack([torch.any(dist > params[c].delta)
                                for dist, c in zip(dists, due)]).tolist()
            for c, bit in zip(due, bits):
                fire[c] = bit
        for c in range(n):
            if fire[c]:
                mc = models[c] if c in models else models_of(c)
                mc, refs[c], nbytes, ledgers[c], eps = _sync(
                    sub, topology, mc, ledgers[c], m)
                models[c] = mc
                if stacked:
                    _set_rows(sub.models_of(state), c, m, mc)
                else:
                    states[c] = sub.with_models(states[c], mc)
                bytes_out[c, t] = nbytes
                eps_out[c, t] = eps
                flags[c, t] = True
            if record:
                div_out[c, t] = sub.divergence(
                    models[c] if c in models else models_of(c))

    return (loss_out.cpu().numpy(), err_out.cpu().numpy(),
            bytes_out.cpu().numpy(), div_out.cpu().numpy(), flags,
            eps_out.cpu().numpy())


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
    _refuse_mesh(mesh, "engine.sweep")
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
    dev = device_mod.resolve(device)
    if data_batched:
        Xs = [torch.as_tensor(X[i], device=dev) for i in range(n)]
        Ys = [torch.as_tensor(Y[i], device=dev) for i in range(n)]
    else:
        Xs = [torch.as_tensor(X, device=dev)] * n
        Ys = [torch.as_tensor(Y, device=dev)] * n

    losses = np.zeros((n, T), np.float32)
    errors = np.zeros((n, T), np.float32)
    round_bytes = np.zeros((n, T), np.int64)
    flags = np.zeros((n, T), bool)
    divs = np.zeros((n, T), np.float32)
    eps = np.zeros((n, T), np.float32)
    for sub, idx in groups.items():
        lo, er, nb, dv, fl, ep = _sweep_group(
            sub.on(dev), [pcfgs[i] for i in idx], [Xs[i] for i in idx],
            [Ys[i] for i in idx],
            bool(record_divergence) or sub.free_divergence, topology, dev)
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
