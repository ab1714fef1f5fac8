"""Message-passing nodes of the asynchronous runtime (port of
``repro/runtime/nodes.py``: the same protocol, messages, event order
and trace events).

A :class:`LearnerNode` runs any ``core.substrate`` learner on its own
stream at its own (straggler-perturbed) pace; a
:class:`CoordinatorNode` owns the reference model and aggregates
arriving models with staleness weights.  Nodes interact ONLY through
``transport.Network`` messages — there is no shared state and no
global barrier, so the same node code would run unchanged over real
sockets.

Everything representation-specific — local update, prediction,
local-condition distance, upload/download payload sizing (Sec. 3 delta
encoding for SV, fixed-size vectors for RFF / linear), and the
staleness-weighted aggregation — goes through the
``core.substrate.Substrate`` node face.  A learner's model and stream
stay on the device; the host reads back one round's loss, prediction
and label in one transfer, each checked distance, and each upload's id
set.

Message kinds (all payloads are plain dicts):

  report   learner -> coord   local-condition violation (control)
  pull     coord  -> learner  request for the current model (control)
  upload   learner -> coord   delta-encoded model
  download coord  -> learner  delta-encoded aggregated reference

The dynamic flow is: a learner that observes ``||f_i - r||^2 > Delta``
sends ``report``; the coordinator opens an *episode* (ignoring further
reports while one is open) and pulls every learner; each pull is
answered at most once per episode.  Arriving uploads are collected in
an aggregation window; at window close the coordinator aggregates
whatever arrived — late stragglers simply open the next window and are
discounted by their staleness weight.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from ..core.accounting import ByteModel
from ..core.substrate import Substrate, node_ops
from ..telemetry.trace import PID_RUNTIME
from .async_protocol import AsyncProtocolConfig, staleness_weight
from .clock import Clock
from .transport import Message, Network

COORD = "coord"


class LearnerNode:
    """One online learner on its own stream.

    Processes round t at its own pace (``compute_times[t]`` apart),
    checks the local condition against the last reference it received,
    and speaks the async protocol of the module docstring.  Never
    blocks: syncs in flight do not stop the stream.
    """

    def __init__(
        self,
        idx: int,
        sub: Substrate,
        acfg: AsyncProtocolConfig,
        bm: ByteModel,
        clock: Clock,
        network: Network,
        X: torch.Tensor,            # (T, d) this learner's stream
        Y: torch.Tensor,            # (T,)   on the device
        compute_times: np.ndarray,  # (T,)
        loss_out: np.ndarray,       # (T, m) harness-owned
        err_out: np.ndarray,
        snapshot: Optional[Callable[[int, int, Any], None]] = None,
    ):
        self.idx = idx
        self.name = f"learner{idx}"
        self.sub, self.acfg, self.bm = sub, acfg, bm
        self.clock, self.network = clock, network
        self.X, self.Y, self.compute_times = X, Y, compute_times
        self.ops = node_ops(sub)
        self.loss_out, self.err_out = loss_out, err_out
        self.snapshot = snapshot

        self.state = sub.init_node(idx, X.device)
        self.reference = None        # set by harness before start()
        self.known_union: Set[int] = set()
        self.ref_version = 0
        self.t = 0                   # rounds completed
        self.last_upload_episode = -1
        self.finish_time = 0.0
        network.register(self.name, self.handle)

    # -- stream processing --------------------------------------------------

    def start(self) -> None:
        self.clock.schedule(float(self.compute_times[0]), self._round)

    def _round(self) -> None:
        t = self.t
        x, y = self.X[t], self.Y[t]
        # one round = predict (service quality, pre-update, as in the
        # lockstep engine) + update; fused where the substrate shares
        # work between the two (e.g. the RFF feature map)
        self.state, loss, yhat = self.ops.round(self.state, (x, y))
        loss_v, yhat_v, y_v = torch.stack([loss, yhat, y]).cpu().numpy()
        if self.sub.loss == "hinge":
            # zero margin predicts +1, identically in every entry point
            # (engine._err_terms)
            pred = 1.0 if float(yhat_v) >= 0.0 else -1.0
            self.err_out[t, self.idx] = float(pred != float(y_v))
        else:
            self.err_out[t, self.idx] = float((yhat_v - y_v) ** 2)
        self.loss_out[t, self.idx] = float(loss_v)
        self.t = t + 1
        if self.snapshot is not None:
            self.snapshot(t, self.idx, self._model())

        tracer = self.network.tracer
        if tracer is not None:
            # the round slice ends NOW (this event fired at completion)
            # and lasted this round's drawn compute time
            ct = float(self.compute_times[t])
            tracer.complete(
                "round", self.clock.now - ct, ct, pid=PID_RUNTIME,
                tid=tracer.tid(PID_RUNTIME, self.name),
                args={"t": t, "loss": self.loss_out[t, self.idx]})

        self._maybe_communicate(t)

        if self.t < len(self.X):
            self.clock.schedule(float(self.compute_times[self.t]), self._round)
        else:
            self.finish_time = self.clock.now

    def _model(self):
        return self.sub.node_model(self.state)

    def _maybe_communicate(self, t: int) -> None:
        if self.acfg.kind == "periodic":
            if (t + 1) % self.acfg.period == 0:
                self._upload(round_idx=t)
        else:  # dynamic: report a violation the moment we observe one
            if (t + 1) % self.acfg.mini_batch == 0 and self._violated():
                self.network.send(self.name, COORD, "report",
                                  {"round": t, "learner": self.idx},
                                  self.acfg.control_bytes, round=t)

    def _violated(self) -> bool:
        d = float(self.ops.dist(self._model(), self.reference))
        return d > self.acfg.delta

    # -- protocol messages --------------------------------------------------

    def handle(self, msg: Message) -> None:
        if msg.kind == "pull":
            episode = msg.payload["episode"]
            if episode > self.last_upload_episode:
                self.last_upload_episode = episode
                self._upload(round_idx=self.t - 1, episode=episode)
        elif msg.kind == "download":
            self._adopt(msg.payload)
        else:
            raise ValueError(f"learner got unexpected {msg.kind!r}")

    def _upload(self, round_idx: int, episode: Optional[int] = None) -> None:
        model, ids, nbytes = self.sub.upload_payload(
            self.bm, self.state, self.known_union)
        self.network.send(
            self.name, COORD, "upload",
            {"learner": self.idx, "model": model, "ids": ids,
             "version": self.ref_version, "round": round_idx,
             "episode": episode},
            nbytes, round=round_idx)

    def _adopt(self, payload: Dict[str, Any]) -> None:
        """Adopt the aggregated reference (the serial ``set_all``)."""
        fsync = payload["model"]
        self.state = self.sub.adopt_node(self.state, fsync)
        self.reference = fsync
        self.known_union = payload["union"]
        self.ref_version = payload["version"]
        if self.snapshot is not None and self.t > 0:
            self.snapshot(self.t - 1, self.idx, self._model())


class CoordinatorNode:
    """Reference-model owner; staleness-weighted aggregation, no barrier."""

    def __init__(
        self,
        sub: Substrate,
        acfg: AsyncProtocolConfig,
        bm: ByteModel,
        clock: Clock,
        network: Network,
        m: int,
        reference0,
        episode_timeout: Optional[float] = None,
    ):
        self.sub, self.acfg, self.bm = sub, acfg, bm
        self.clock, self.network, self.m = clock, network, m
        self.reference = reference0
        self.version = 0
        self.episode_ctr = 0
        self.episode_open = False
        self.window_open = False
        self.window: Dict[int, Dict[str, Any]] = {}   # learner -> upload
        self.eps_history: List[float] = []
        self.sync_log: List[Dict[str, Any]] = []
        self.staleness_seen: List[int] = []
        self._episode_start = 0.0    # trace: episode-open time
        self._window_start = 0.0     # trace: aggregation-window open time
        # generous default: a lost pull/upload must not wedge the
        # protocol; after the timeout new reports may re-trigger pulls.
        if episode_timeout is None:
            sys_cfg = network.model.cfg
            episode_timeout = acfg.agg_window + 1.0 + 8.0 * sys_cfg.base_latency
        self.episode_timeout = episode_timeout
        network.register(COORD, self.handle)

    def handle(self, msg: Message) -> None:
        if msg.kind == "report":
            self._on_report(msg)
        elif msg.kind == "upload":
            self._on_upload(msg)
        else:
            raise ValueError(f"coordinator got unexpected {msg.kind!r}")

    def _on_report(self, msg: Message) -> None:
        if self.episode_open:
            return                      # a sync is already in flight
        self.episode_open = True
        self.episode_ctr += 1
        self._episode_start = self.clock.now
        episode = self.episode_ctr
        for i in range(self.m):
            self.network.send(COORD, f"learner{i}", "pull",
                              {"episode": episode},
                              self.acfg.control_bytes, round=msg.round)
        self.clock.schedule(self.episode_timeout,
                            lambda: self._episode_timeout(episode))

    def _episode_timeout(self, episode: int) -> None:
        # pulls or every upload of this episode were lost: clear the
        # in-flight flag so a later report can re-trigger a sync.  A
        # window holding this episode's uploads clears it itself.
        if self.episode_open and self.episode_ctr == episode and not any(
                e.get("episode") == episode for e in self.window.values()):
            self.episode_open = False

    def _on_upload(self, msg: Message) -> None:
        self.window[msg.payload["learner"]] = msg.payload
        if not self.window_open:
            self.window_open = True
            self._window_start = self.clock.now
            self.clock.schedule(self.acfg.agg_window, self._close_window)

    def _close_window(self) -> None:
        entries = list(self.window.values())
        self.window = {}
        self.window_open = False
        # Only the window that merged the CURRENT episode's uploads
        # resolves it — a straggler window replaying an old episode
        # must not clear the flag of a sync still in flight.
        resolved_episode = any(
            e.get("episode") == self.episode_ctr for e in entries)
        if resolved_episode:
            self.episode_open = False
        if not entries:
            return

        lags = [self.version - e["version"] for e in entries]
        weights = [self.acfg.alpha * staleness_weight(self.acfg, lag)
                   for lag in lags]
        self.staleness_seen.extend(lags)
        models = [e["model"] for e in entries]

        fsync, eps, union = self.sub.aggregate(self.reference, models, weights)
        if eps is not None:
            self.eps_history.append(eps)
        self.version += 1
        self.reference = fsync

        trigger_round = max(e["round"] for e in entries)
        payload = {"model": fsync, "union": union, "version": self.version}
        for e in entries:
            nbytes = self.sub.download_payload_bytes(self.bm, union, e["ids"])
            self.network.send(COORD, f"learner{e['learner']}", "download",
                              payload, nbytes, round=trigger_round)
        self.sync_log.append({
            "round": trigger_round,
            "time": self.clock.now,
            "n_models": len(entries),
            "version": self.version,
            "max_lag": max(lags),
        })

        tracer = self.network.tracer
        if tracer is not None:
            tid = tracer.tid(PID_RUNTIME, COORD)
            args = {"round": trigger_round, "n_models": len(entries),
                    "version": self.version, "max_lag": max(lags)}
            # the aggregation window that just closed ...
            tracer.complete("sync/window", self._window_start,
                            self.clock.now - self._window_start,
                            pid=PID_RUNTIME, tid=tid, args=args)
            # ... and, when it resolved a dynamic episode, the whole
            # report -> pulls -> uploads -> aggregate span
            if resolved_episode:
                tracer.complete("sync/episode", self._episode_start,
                                self.clock.now - self._episode_start,
                                pid=PID_RUNTIME, tid=tid,
                                args=dict(args, episode=self.episode_ctr))
