"""Substrate-native online serving engine (port of
``repro/serving/engine.py``).

A :class:`KernelServingEngine` fronts the m learners of any
``core.substrate.Substrate`` — SV expansion, random Fourier features,
linear; ``backend="reference"`` or ``"kernels"`` — and runs three
things on ONE seeded discrete-event timeline (``runtime.clock``):

- **predict requests**, scheduled by a batch policy
  (``serving/scheduler.py``): ``policy="continuous"`` (slotted
  continuous batching) or ``policy="tick"`` (the static grid).  A
  launch is ONE ``Substrate.predict_batch`` call on a padded bucket
  built on the host and moved to the device: under an engaged
  ``backend="kernels"`` that is one ``sv_predict`` launch (SV) or one
  ``rff`` launch (RFF) per bucket;
- **labeled feedback**, queued per learner: the moment every learner
  has its next example, one protocol round runs through the engine's
  OWN step function (``core.engine.make_protocol_step``), so losses,
  sync decisions and the Sec. 3 byte ledger are those of
  ``engine.run`` on the same stream and device, bitwise, by
  construction.  Rounds apply at feedback-completion time, so no
  scheduler decision can reach the protocol state;
- **background synchronization**: a sync's Sec. 3 bytes are priced
  into simulated network time by the seeded ``SystemModel`` and the
  transfer completes as a clock event.

Several protocol instances can share one engine, one slot pool and
one admission queue (``add_tenant``); launches never mix tenants.

The serving face (latencies, queue depths, bucket counts, launches,
sheds, deferrals, sync delays, ticks, the simulated wall clock) lives
on the seeded event clock and depends on the protocol view only
through the sync rounds and their bytes, so it equals the reference's
exactly (tests/test_torch_serving.py).

Mesh-awareness: pass ``mesh=`` (``launch.mesh.make_learner_mesh``;
``launch.serve.make_kernel_serving_engine`` builds one) and the engine
routes each request to its *home shard*, a contiguous block of m / n
learners (``home_shard``): a chunk never mixes learners of two shards,
each shard has its own slot pool, and the predict models are placed
per shard (each block on its shard's device, placed again after every
round), so a chunk's ``predict_batch`` launches on its home shard's
device.  Rounds stay on the lead device, as the reference's do, so a
mesh server's ``sim`` equals the unmeshed server's bitwise.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import substrate as substrate_mod
from ..core.engine import (allreduce_cost, assemble_sim_result,
                           init_protocol_carry, make_protocol_step, params_of,
                           shard_devices)
from ..core.protocol import ProtocolConfig
from ..core.simulation import SimResult
from ..core.substrate import Substrate
from ..runtime.clock import Clock, SystemConfig, SystemModel
from ..telemetry.trace import PID_SERVING, Tracer
from .arrivals import ArrivalProcess
from .scheduler import POLICIES, SlotScheduler, make_scheduler

#: Default padded-batch sizes.  Ascending; a launch's requests are
#: chunked to the largest bucket and each chunk padded up to the
#: smallest bucket that fits.
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


# ---------------------------------------------------------------------------
# Requests and results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PredictRequest:
    """One predict request: answer ``x`` with learner ``learner``'s
    current model in tenant ``tenant``.  ``arrival`` / ``done_time``
    are simulated times on the engine's event clock; ``latency`` is
    their difference.  A ``shed`` request was refused by admission
    control and never answered."""

    uid: int
    learner: int
    x: np.ndarray                    # (d,)
    arrival: float
    tenant: int = 0
    yhat: float = math.nan
    done_time: float = math.nan
    shed: bool = False
    deferrals: int = 0

    @property
    def done(self) -> bool:
        return not math.isnan(self.done_time)

    @property
    def latency(self) -> float:
        return self.done_time - self.arrival


@dataclasses.dataclass
class ServeResult:
    """What one serving run produced, on both of its faces.

    The protocol face is ``sim``, a :class:`SimResult` equal to
    ``engine.run``'s on the same feedback stream and device.  The
    serving face is everything a latency SLO cares about, all of it on
    the simulated clock.  ``latencies``, ``sync_delays`` and ``rounds``
    are the tenant's own; ``queue_depth``, ``bucket_counts``,
    ``launches`` and the admission counters are engine-wide.  Summary
    statistics are NaN-free, also on empty and single-request runs.
    """

    sim: SimResult
    latencies: np.ndarray            # per served request, completion order
    queue_depth: np.ndarray          # pending predicts at each sample
    bucket_counts: Dict[int, int]    # bucket size -> batches served
    sync_delays: np.ndarray          # simulated network time per sync
    rounds: int                      # protocol rounds applied
    ticks: int                       # tick events (0 under continuous)
    wall_clock: float                # simulated time at quiescence
    launches: int = 0                # predict batches launched
    num_shed: int = 0                # requests refused by admission
    num_deferred: int = 0            # deferral retries priced on the clock
    policy: str = "tick"
    slots: int = 1

    @property
    def num_requests(self) -> int:
        return int(len(self.latencies))

    @property
    def num_syncs(self) -> int:
        return self.sim.num_syncs

    @property
    def total_bytes(self) -> int:
        return self.sim.total_bytes

    @property
    def total_loss(self) -> float:
        return self.sim.total_loss

    @property
    def mean_latency(self) -> float:
        return float(self.latencies.mean()) if len(self.latencies) else 0.0

    @property
    def max_latency(self) -> float:
        return float(self.latencies.max()) if len(self.latencies) else 0.0

    @property
    def mean_queue_depth(self) -> float:
        return (float(self.queue_depth.mean())
                if len(self.queue_depth) else 0.0)

    @property
    def max_queue_depth(self) -> int:
        return int(self.queue_depth.max()) if len(self.queue_depth) else 0

    def latency_percentiles(
            self, qs: Sequence[float] = (50.0, 90.0, 99.0),
    ) -> Dict[str, float]:
        """{"p50": ..., "p90": ..., "p99": ...} over served requests:
        0.0 everywhere with none served, the one latency with one."""
        if not len(self.latencies):
            return {f"p{q:g}": 0.0 for q in qs}
        return {f"p{q:g}": float(np.percentile(self.latencies, q))
                for q in qs}

    def summary(self) -> Dict[str, float]:
        """Flat NaN-free scalar summary of the serving face."""
        out = {"requests": float(self.num_requests),
               "rounds": float(self.rounds),
               "launches": float(self.launches),
               "shed": float(self.num_shed),
               "deferred": float(self.num_deferred),
               "mean_latency": self.mean_latency,
               "max_latency": self.max_latency,
               "mean_queue_depth": self.mean_queue_depth,
               "wall_clock": float(self.wall_clock)}
        out.update(self.latency_percentiles())
        return out


def _series(rows: list) -> np.ndarray:
    """Per-round values as one host float32 array: device tensors, or
    the step's host 0.0 where a round produced none."""
    idx = [i for i, r in enumerate(rows) if torch.is_tensor(r)]
    tail = tuple(rows[idx[0]].shape) if idx else ()
    out = np.zeros((len(rows),) + tail, np.float32)
    if idx:
        out[idx] = torch.stack([rows[i] for i in idx]).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Per-tenant protocol state
# ---------------------------------------------------------------------------


class _Tenant:
    """One (substrate, protocol) instance behind the shared engine: its
    substrate on the lead device (``devices[0]``, where its rounds run)
    and on each shard's, its carry, its predict models placed per shard,
    feedback queues and per-round series.  Never touches the
    scheduler."""

    def __init__(self, tid: int, sub: Substrate, pcfg: ProtocolConfig,
                 m: int, topology: str, record_divergence: bool,
                 devices: Sequence[torch.device],
                 name: Optional[str] = None):
        self.tid = tid
        self.name = name or f"tenant{tid}"
        if topology == "allreduce":
            allreduce_cost(sub, m)      # refuse an int32 overflow up front
        # constants (the RFF projection) go to each device once
        device = devices[0]
        self.sub = sub.on(device)
        self.shard_subs = [self.sub] + [sub.on(dev) for dev in devices[1:]]
        self.placed: Optional[list] = None     # the shards' predict models
        self.pcfg = pcfg
        self.record_divergence = bool(record_divergence)
        self.params = params_of(pcfg)
        self.round_op = make_protocol_step(
            self.sub, pcfg.kind, record_divergence=self.record_divergence,
            topology=topology)
        self.carry = init_protocol_carry(self.sub, m, device)
        self.t = 0
        self.fb: List[Deque[Tuple[np.ndarray, float]]] = [
            deque() for _ in range(m)]
        self.served: List[PredictRequest] = []
        self.loss_rows: list = []
        self.err_rows: list = []
        self.byte_rows: List[int] = []
        self.div_rows: list = []
        self.flag_rows: List[bool] = []
        self.eps_rows: list = []
        self.sync_delays: List[float] = []


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class KernelServingEngine:
    """Online serving front for m distributed substrate learners.

    Usage (see also :func:`serve_stream`)::

        eng = KernelServingEngine(sub, pcfg, m=4, policy="continuous",
                                  slots=2, slo=0.25, max_queue=256)
        eng.submit(x, learner=2, at=0.7)          # predict request
        eng.feedback(x, y, learner=2, at=1.1)     # labeled example
        res = eng.serve()                         # run clock to drain

    ``submit`` / ``feedback`` schedule arrivals on the event clock;
    nothing computes until :meth:`serve` runs the clock.  Constructor
    keywords are the reference's; ``sync_budget`` / ``compress_method``
    / ``backend`` are ``None`` sentinels meaning "keep the substrate's
    own configuration" (``backend="kernels"`` is the counterpart of
    the reference's ``"pallas"``), and ``device`` is where the models
    live (``None``: the CUDA card; ``"cpu"`` runs the plain versions).
    ``mesh`` (a ``launch.mesh.LearnerMesh``; m must divide evenly, and
    ``device``, if given, must be its lead device) routes each request
    to its home shard; ``slots`` is then per shard.

    ``tracer`` (a ``telemetry.Tracer``) records the request lifecycle
    on the simulated clock, event for event as the reference does.
    """

    def __init__(
        self,
        learner,
        pcfg: ProtocolConfig,
        m: int,
        *,
        sync_budget: Optional[int] = None,
        compress_method: Optional[str] = None,   # None -> substrate's own
        backend: Optional[str] = None,           # None -> substrate's own
        topology: str = "coordinator",
        mesh=None,
        sys_cfg: Optional[SystemConfig] = None,
        tick_interval: float = 1.0,
        predict_cost: float = 0.0,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        record_divergence: bool = False,
        tracer: Optional[Tracer] = None,
        policy: str = "tick",
        slots: int = 1,
        max_queue: Optional[int] = None,
        overload: str = "shed",
        defer_interval: Optional[float] = None,
        slo: Optional[float] = None,
        max_wait: Optional[float] = None,
        device=None,
    ):
        if m < 1:
            raise ValueError(f"need at least one learner, got m={m}")
        if tick_interval <= 0:
            raise ValueError(f"tick_interval must be > 0, got {tick_interval}")
        if predict_cost < 0:
            raise ValueError(f"predict_cost must be >= 0, got {predict_cost}")
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")

        # home-shard routing (mesh mode): shard k holds learners
        # [k m/n, (k + 1) m/n) on devices[k]; rounds run on devices[0]
        self.devices = shard_devices(mesh, int(m), device)
        self.device = self.devices[0]
        self._n_shards = len(self.devices)
        self._per_shard = int(m) // self._n_shards
        self.m = int(m)
        self.topology = topology
        self.tick_interval = float(tick_interval)
        self.predict_cost = float(predict_cost)
        self.record_divergence = bool(record_divergence)

        # the seeded timeline; the tracer rides on it
        self.tracer = tracer
        self.clock = Clock(tracer=tracer)
        self.system = SystemModel(sys_cfg or SystemConfig(), self.m)

        # tenant 0 is the constructor's (learner, pcfg)
        self._tenants: List[_Tenant] = []
        self.add_tenant(learner, pcfg, sync_budget=sync_budget,
                        compress_method=compress_method, backend=backend,
                        record_divergence=record_divergence)

        # the predict path: slot pool + batch policy + admission
        self.scheduler: SlotScheduler = make_scheduler(
            policy,
            clock=self.clock,
            predict_fn=self._predict_chunk,
            shard_of=self.home_shard,
            n_shards=self._n_shards,
            buckets=self.buckets,
            predict_cost=self.predict_cost,
            slots=slots,
            max_queue=max_queue,
            overload=overload,
            defer_interval=defer_interval,
            tick_interval=self.tick_interval,
            slo=slo,
            max_wait=max_wait,
            tracer=tracer,
        )
        self.policy = policy
        self._uid = itertools.count()

    # -- tenants -------------------------------------------------------------

    @property
    def sub(self) -> Substrate:
        """Tenant 0's substrate (on the engine's device)."""
        return self._tenants[0].sub

    @property
    def pcfg(self) -> ProtocolConfig:
        return self._tenants[0].pcfg

    @property
    def d(self) -> int:
        return int(self._tenants[0].sub.input_dim)

    @property
    def num_tenants(self) -> int:
        return len(self._tenants)

    def add_tenant(
        self,
        learner,
        pcfg: ProtocolConfig,
        *,
        sync_budget: Optional[int] = None,
        compress_method: Optional[str] = None,
        backend: Optional[str] = None,
        record_divergence: Optional[bool] = None,
        name: Optional[str] = None,
    ) -> int:
        """Register another protocol instance over the same m learners
        behind the shared slot pool; returns its tenant id.  All
        tenants share the input dimension."""
        sub = substrate_mod.substrate_of(
            learner, sync_budget=sync_budget,
            compress_method=compress_method, backend=backend)
        if self._tenants and int(sub.input_dim) != self.d:
            raise ValueError(
                f"tenant input_dim {sub.input_dim} != engine d {self.d}")
        rec = (self.record_divergence if record_divergence is None
               else bool(record_divergence))
        ten = _Tenant(len(self._tenants), sub, pcfg, self.m, self.topology,
                      rec, self.devices, name=name)
        self._tenants.append(ten)
        return ten.tid

    def _tenant(self, tenant: int) -> _Tenant:
        if not (0 <= tenant < len(self._tenants)):
            raise ValueError(f"tenant {tenant} not in "
                             f"[0, {len(self._tenants)})")
        return self._tenants[tenant]

    # -- request ingress -----------------------------------------------------

    def home_shard(self, learner: int) -> int:
        """The mesh shard holding this learner's model slice (0 when
        unmeshed): contiguous blocks of m / n_shards learners."""
        return int(learner) // self._per_shard

    def _check_ingress(self, x, learner: int, at: float) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.shape != (self.d,):
            raise ValueError(f"x shape {x.shape} != ({self.d},)")
        if not (0 <= learner < self.m):
            raise ValueError(f"learner {learner} not in [0, {self.m})")
        if at < self.clock.now:
            raise ValueError(
                f"arrival {at} is in the past (clock at {self.clock.now})")
        return x

    def submit(self, x, *, learner: int = 0, at: float = 0.0,
               tenant: int = 0) -> PredictRequest:
        """Schedule a predict request arriving at simulated time ``at``;
        the batch policy answers it (``yhat`` / ``done_time`` filled)
        — or admission control sheds it (``shed`` set, never served)."""
        x = self._check_ingress(x, learner, at)
        self._tenant(tenant)
        req = PredictRequest(uid=next(self._uid), learner=int(learner),
                             x=x, arrival=float(at), tenant=int(tenant))
        self.clock.schedule(at - self.clock.now,
                            lambda: self._arrive_predict(req))
        return req

    def feedback(self, x, y, *, learner: int, at: float = 0.0,
                 tenant: int = 0) -> None:
        """Schedule a labeled example arriving at simulated time ``at``.
        Examples queue per learner FIFO; each time every learner has
        one queued, one protocol round applies.  Feedback is never
        admission-controlled."""
        x = self._check_ingress(x, learner, at)
        self._tenant(tenant)
        item = (x, float(y))
        self.clock.schedule(
            at - self.clock.now,
            lambda: self._arrive_feedback(int(learner), item, int(tenant)))

    # -- event handlers ------------------------------------------------------

    def _arrive_predict(self, req: PredictRequest) -> None:
        if self.tracer is not None:
            self.tracer.instant(
                "enqueue", self.clock.now, pid=PID_SERVING,
                tid=self.tracer.tid(PID_SERVING, "requests"),
                args={"uid": req.uid, "learner": req.learner,
                      "tenant": req.tenant})
        self.scheduler.submit(req)

    def _arrive_feedback(self, learner: int,
                         item: Tuple[np.ndarray, float],
                         tenant: int) -> None:
        ten = self._tenants[tenant]
        ten.fb[learner].append(item)
        while all(ten.fb):          # full rounds apply immediately
            xs = np.stack([ten.fb[i][0][0] for i in range(self.m)])
            ys = np.asarray([ten.fb[i][0][1] for i in range(self.m)],
                            np.float32)
            for q in ten.fb:
                q.popleft()
            self._apply_round(ten, xs, ys)

    # -- the predict path (called by the scheduler) --------------------------

    def _models_for_predict(self, ten: _Tenant) -> list:
        """The tenant's models placed per shard (one block a shard, on
        its device), placed again after every round."""
        if ten.placed is None:
            ten.placed = substrate_mod.shard_rows(
                ten.sub.models_of(ten.carry[0]), self.devices)
        return ten.placed

    def _predict_chunk(self, chunk: List[PredictRequest],
                       bucket: int) -> np.ndarray:
        """One padded-bucket predict for a (tenant, shard) chunk — the
        scheduler's ``predict_fn``: the bucket is built on the host,
        moved to the home shard's device, and answered there by one
        ``predict_batch`` call on the shard's models.  Padding rows
        reuse the chunk's first learner id, so the gather never leaves
        the home shard."""
        ten = self._tenants[chunk[0].tenant]
        shard = self.home_shard(chunk[0].learner)
        models = self._models_for_predict(ten)[shard]
        dev = self.devices[shard]
        base = shard * self._per_shard
        lids = np.full((bucket,), chunk[0].learner - base, np.int64)
        Xb = np.zeros((bucket, self.d), np.float32)
        for i, r in enumerate(chunk):
            lids[i] = r.learner - base
            Xb[i] = r.x
        yh = ten.shard_subs[shard].predict_batch(
            models, torch.as_tensor(lids, device=dev),
            torch.as_tensor(Xb, device=dev))
        ten.served.extend(chunk)
        return yh.cpu().numpy()

    # -- protocol rounds -----------------------------------------------------

    def _apply_round(self, ten: _Tenant, x_row: np.ndarray,
                     y_row: np.ndarray) -> None:
        """One protocol round through the engine's step (the
        parity-critical path — see the module docstring)."""
        ten.sub.validate(ten.t + 1, self.m, self.d)   # sv_id capacity
        xs = (torch.as_tensor(x_row, device=self.device),
              torch.as_tensor(y_row, device=self.device), ten.t)
        ten.carry, outs = ten.round_op(ten.params, ten.carry, xs)
        ten.placed = None       # the next launch places the new models
        loss, err, nbytes, div, fired, eps = outs
        nbytes = int(nbytes)        # the int 0 unless the round synced
        ten.loss_rows.append(loss)
        ten.err_rows.append(err)
        ten.byte_rows.append(nbytes)
        ten.div_rows.append(div)
        ten.eps_rows.append(eps)
        ten.flag_rows.append(fired)
        ten.t += 1
        if self.tracer is not None:
            self.tracer.instant(
                "round", self.clock.now, pid=PID_SERVING,
                tid=self.tracer.tid(PID_SERVING, "protocol"),
                args={"t": ten.t - 1, "tenant": ten.tid,
                      "nbytes": nbytes, "sync": fired})
        if fired:
            # background sync: price the Sec. 3 bytes into simulated
            # network time and let it complete as a clock event
            delay = self.system.draw_latency(nbytes)
            ten.sync_delays.append(delay)
            if self.tracer is not None:
                self.tracer.complete(
                    "sync/transfer", self.clock.now, delay,
                    pid=PID_SERVING,
                    tid=self.tracer.tid(PID_SERVING, "protocol"),
                    args={"t": ten.t - 1, "tenant": ten.tid,
                          "nbytes": nbytes})
            if delay > 0:
                self.clock.schedule(delay, lambda: None)

    # -- running and results -------------------------------------------------

    @property
    def rounds_applied(self) -> int:
        return self._tenants[0].t

    def serve(self, tenant: int = 0) -> ServeResult:
        """Run the event clock to quiescence and package the results
        (of ``tenant``; see :meth:`results` for all tenants)."""
        self.clock.run()
        return self.result(tenant)

    def results(self) -> List[ServeResult]:
        """Per-tenant snapshots, tenant order."""
        return [self.result(t) for t in range(len(self._tenants))]

    def result(self, tenant: int = 0) -> ServeResult:
        """Snapshot of everything served/learned so far.  ``sim`` is
        assembled by ``engine.assemble_sim_result``, the host-side
        post-processing ``engine.run`` uses."""
        ten = self._tenant(tenant)
        if ten.t:
            loss = _series(ten.loss_rows)            # (T, m) float32
            err = _series(ten.err_rows)
            div = _series(ten.div_rows)
            eps = _series(ten.eps_rows)
        else:
            loss = np.zeros((0, self.m), np.float32)
            err = np.zeros((0, self.m), np.float32)
            div = np.zeros((0,), np.float32)
            eps = np.zeros((0,), np.float32)
        sim = assemble_sim_result(
            ten.sub, ten.record_divergence, loss, err,
            np.asarray(ten.byte_rows, np.int64), div,
            np.asarray(ten.flag_rows, bool), eps)
        sched = self.scheduler
        return ServeResult(
            sim=sim,
            latencies=np.asarray([r.latency for r in ten.served]),
            queue_depth=np.asarray(sched.queue_depth, np.int64),
            bucket_counts=dict(sched.bucket_counts),
            sync_delays=np.asarray(ten.sync_delays),
            rounds=ten.t,
            ticks=sched.ticks,
            wall_clock=self.clock.now,
            launches=sched.launches,
            num_shed=sched.num_shed,
            num_deferred=sched.num_deferred,
            policy=sched.POLICY,
            slots=sched.slots,
        )


# ---------------------------------------------------------------------------
# Stream replay
# ---------------------------------------------------------------------------


def serve_stream(
    learner,
    pcfg: ProtocolConfig,
    X: np.ndarray,          # (T, m, d)
    Y: np.ndarray,          # (T, m)
    *,
    queries_per_round: float = 0.0,
    query_seed: int = 0,
    arrivals: Optional[ArrivalProcess] = None,
    **engine_kw,
) -> ServeResult:
    """Replay a (T, m, d) protocol stream through the serving engine.

    Learner i's round-t labeled example arrives when that learner
    finishes computing round t on the seeded timeline (the cumulative
    sum of ``SystemModel.draw_compute``).  Query traffic rides along:
    ``queries_per_round * T`` requests at seeded uniform times over the
    feedback horizon, or the times of ``arrivals=`` (an
    :class:`serving.arrivals.ArrivalProcess`).  Home learners and
    inputs are resampled from the stream under ``query_seed``.
    ``engine_kw`` forwards to :class:`KernelServingEngine` (policy,
    slots, admission, SLO, ``device``, ...).
    """
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    eng = KernelServingEngine(learner, pcfg, m, **engine_kw)
    eng.sub.validate(T, m, d)
    arrive = np.cumsum(eng.system.draw_compute(T), axis=0)   # (T, m)
    for t in range(T):
        for i in range(m):
            eng.feedback(X[t, i], Y[t, i], learner=i,
                         at=float(arrive[t, i]))
    horizon = float(arrive.max())
    rng = np.random.default_rng(query_seed)
    if arrivals is not None:
        times = arrivals.times(horizon)
    else:
        n_q = int(round(queries_per_round * T))
        times = (np.sort(rng.uniform(0.0, horizon, size=n_q))
                 if n_q else np.zeros((0,)))
    for tq in times:
        lid = int(rng.integers(m))
        x = X[int(rng.integers(T)), lid]
        eng.submit(x, learner=lid, at=float(tq))
    return eng.serve()
