"""Asynchronous experiment harness (port of ``repro/runtime/harness.py``).

Runs the same (stream, learner, kernel) workloads as ``core.engine``
through the event-driven runtime and reports the same ``SimResult``
fields, plus async-only metrics (simulated wall-clock, per-link bytes,
staleness statistics).

The learner may be anything ``core.substrate.substrate_of`` resolves —
a ``LearnerConfig`` (SV or linear), an ``RFFSpec``, or a ``Substrate``
instance.  The learners' models and streams live on ``device`` (the
CUDA card unless ``device="cpu"``); the event loop, the byte ledger
and the round-indexed series live on the host.

Round-indexed series keep the lockstep engine's semantics: learners may
reach round t at very different simulated times, but
``cumulative_loss[t]`` always sums every learner's first t+1 rounds,
and a synchronization's bytes are attributed to the learner round that
triggered it.  With an ideal network (zero latency, no stragglers,
``alpha = 1``, constant staleness) the async dynamic protocol's event
trace collapses to the lockstep round structure: sync rounds and byte
ledger equal ``engine.run``'s (tests/test_torch_runtime.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as device_mod
from ..core import accounting
from ..core.simulation import SimResult
from ..core.substrate import substrate_of
from .async_protocol import AsyncProtocolConfig
from .clock import Clock, SystemConfig, SystemModel, barrier_wall_clock
from .nodes import CoordinatorNode, LearnerNode
from .transport import Network


@dataclasses.dataclass
class AsyncSimResult(SimResult):
    """SimResult plus the quantities only an async system has."""

    wall_clock: float = 0.0            # simulated time to finish all streams
    barrier_wall_clock: float = 0.0    # lockstep baseline on the same draws
    link_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    mean_staleness: float = 0.0        # mean version lag of merged models
    max_staleness: int = 0
    num_dropped: int = 0
    events_processed: int = 0

    @property
    def speedup_vs_barrier(self) -> float:
        return self.barrier_wall_clock / max(self.wall_clock, 1e-12)


def run_async_simulation(
    learner,
    acfg: AsyncProtocolConfig,
    X: np.ndarray,              # (T, m, d)
    Y: np.ndarray,              # (T, m)
    sys_cfg: Optional[SystemConfig] = None,
    sync_budget: Optional[int] = None,
    compress_method: Optional[str] = None,   # None -> substrate's own
    record_divergence: bool = True,
    barrier_num_syncs: Optional[int] = None,
    backend: Optional[str] = None,           # None -> substrate's own
    tracer=None,                             # telemetry.Tracer, optional
    *,
    device=None,
) -> AsyncSimResult:
    """Run T rounds of m learners under the asynchronous protocol, on
    ``device`` (default the CUDA card; ``device="cpu"`` runs the plain
    versions).  ``backend="kernels"`` is the counterpart of the
    reference's ``"pallas"``.

    ``compress_method=None`` / ``backend=None`` keep the substrate's
    own configuration (``compression.DEFAULT_METHOD`` — "truncate" —
    and "reference" for a LearnerConfig); see
    ``substrate.substrate_of`` for the full sentinel semantics.

    record_divergence keeps per-round model snapshots — O(T m |model|)
    memory — because an async run has no global round boundary at
    which divergence could be computed streaming; pass False for large
    T (at m = 32, budget 1024, d = 18, T = 1000 the SV snapshots are
    2.4 GB of host memory).

    barrier_num_syncs prices the lockstep baseline's per-sync round
    trips.  Async windowing can fragment aggregations, so for a fair
    baseline pass the SERIAL simulator's sync count on the same
    workload; defaults to this run's own count.

    tracer: a ``telemetry.Tracer`` records the run's full event trace
    on the simulated clock — learner round slices, message spans with
    their Sec. 3 byte annotations, aggregation windows and dynamic sync
    episodes — a pure function of the seeds.
    """
    dev = device_mod.resolve(device)
    sub = substrate_of(learner, sync_budget=sync_budget,
                       compress_method=compress_method, backend=backend)
    X = np.asarray(X, np.float32)
    Y = np.asarray(Y, np.float32)
    T, m, d = X.shape
    sub.validate(T, m, d)
    sub = sub.on(dev)
    # the streams go to the device once per run
    Xd = torch.as_tensor(X, device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    sys_cfg = sys_cfg or SystemConfig()
    model = SystemModel(sys_cfg, m)
    compute_times = model.draw_compute(T)

    clock = Clock(tracer=tracer)
    network = Network(clock, model)
    bm = accounting.ByteModel(dim=d)

    loss_out = np.zeros((T, m))
    err_out = np.zeros((T, m))

    if record_divergence:
        bufs = sub.snapshot_buffers(T, m)

        def snapshot(t, i, f):
            sub.write_snapshot(bufs, t, i, f)
    else:
        snapshot = None

    reference0 = sub.init_reference(dev)
    coord = CoordinatorNode(sub, acfg, bm, clock, network, m, reference0)
    nodes = []
    for i in range(m):
        node = LearnerNode(
            i, sub, acfg, bm, clock, network,
            Xd[:, i], Yd[:, i], compute_times[:, i],
            loss_out, err_out, snapshot=snapshot)
        node.reference = reference0
        nodes.append(node)
    for node in nodes:
        node.start()
    clock.run()

    # ---- round-indexed series ---------------------------------------------
    cum_loss = np.cumsum(loss_out.sum(axis=1))
    cum_err = np.cumsum(err_out.sum(axis=1))
    bytes_by_round = np.zeros((T,), np.int64)
    for rnd, nbytes, _kind in network.sent:
        bytes_by_round[min(max(rnd, 0), T - 1)] += nbytes
    cum_bytes = np.cumsum(bytes_by_round)

    sync_rounds = np.sort(np.asarray(
        [s["round"] for s in coord.sync_log], dtype=np.int64))

    divs = sub.divergence_series(bufs, dev) if record_divergence \
        else np.zeros((T,))

    lags = coord.staleness_seen
    return AsyncSimResult(
        cumulative_loss=cum_loss,
        cumulative_bytes=cum_bytes,
        cumulative_errors=cum_err,
        sync_rounds=sync_rounds,
        divergences=divs,
        eps_history=np.asarray(coord.eps_history),
        num_syncs=len(coord.sync_log),
        total_bytes=int(network.total_bytes),
        total_loss=float(cum_loss[-1]) if T else 0.0,
        wall_clock=max((n.finish_time for n in nodes), default=0.0),
        barrier_wall_clock=barrier_wall_clock(
            compute_times,
            len(coord.sync_log) if barrier_num_syncs is None
            else barrier_num_syncs,
            model, sync_bytes=int(network.total_bytes)),
        link_bytes=network.link_bytes(),
        mean_staleness=float(np.mean(lags)) if lags else 0.0,
        max_staleness=int(np.max(lags)) if lags else 0,
        num_dropped=network.dropped,
        events_processed=clock.events_processed,
    )


# Convenience wrappers mirroring the reference's entry points.


def run_async_kernel_simulation(lcfg, acfg, X, Y, **kw) -> AsyncSimResult:
    assert lcfg.is_kernel
    return run_async_simulation(lcfg, acfg, X, Y, **kw)


def run_async_linear_simulation(lcfg, acfg, X, Y, **kw) -> AsyncSimResult:
    assert not lcfg.is_kernel
    return run_async_simulation(lcfg, acfg, X, Y, **kw)
