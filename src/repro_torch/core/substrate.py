"""Learner substrates: the protocol-facing model interface (port of
``repro/core/substrate.py``, its scan face).

A substrate packages what the protocols do with a model: the local
round, the Prop. 2 average, the distance to the reference model, and
the Sec. 3 bytes a synchronization costs.  The engine (core/engine.py)
has one code path for every representation:

- :class:`SVSubstrate`     — budgeted support-vector expansion, with
  the device ledger's delta-encoded id accounting.
- :class:`RFFSubstrate`    — primal weights over D random Fourier
  features: a fixed ``2 m (D+1) B`` bytes per sync.
- :class:`LinearSubstrate` — the paper's Euclidean baselines.

State is stacked over the learner axis m; where the reference vmaps a
per-learner function the port writes the batch axis out.

Backends: ``"reference"`` evaluates the plain expressions of
core/rkhs.py and core/rff.py; ``"kernels"`` (the counterpart of the
reference's ``"pallas"``) routes predict, the RFF featurization, the
fused round and the dynamic distance through ``kernels.ops``.  The
dispatch is engage-aware (``ops.engages``): below the 128 threshold
the kernels backend runs the reference expressions verbatim, the same
shape rule as the JAX package.

The serving face: ``predict_batch(models, lids, Xb)`` answers a padded
bucket of requests, row i by learner ``lids[i]``, and ``predict_one``
one request.  Both go through ``predict_rows``, so the serving
contract — a bucket's row equals ``predict_one`` on that row bitwise —
holds when ``predict_rows`` is row-independent: its kernels compute
each row alone (``sv_predict``: a block per row; ``rff``: a thread per
element), and every reduction around or instead of them (the primal
row dot; below the threshold the SV expansion and the RFF projection)
is :func:`_rowsum`, a fixed pairwise tree, because PyTorch's CUDA
reduction splits a row among a number of threads that depends on the
row count.

The node face (one model per node, the asynchronous runtime's
``runtime/nodes.py``): ``init_node / node_model / update_one /
predict_one / dist_one / init_reference / upload_payload /
download_payload_bytes / aggregate / adopt_node`` and the snapshot
hooks of ``runtime/harness.py``, composed as the reference composes a
node round: SV unfused (the error record from ``predict_one``, the
update with its own plain prediction), RFF fused (one featurization of
the row for both), linear plain.  Under ``"kernels"`` a node round
launches ``sv_predict`` or ``rff`` on one row, the dynamic check one
``quadform`` launch of 3 forms, and an SV aggregate one ``quadform``
form over the 2 n tau slots of its mix (no Gram).

The participation face (a sampled cohort, ``population/``):
``average_stacked_masked / sync_payload_masked / rejoin_payload_bytes /
allreduce_sync_bytes_masked``.  ``mask`` is an (m,) bool array (the
engine passes the host's row of the participation mask, so the cohort
size needs no read back) or tensor.  With every learner in the cohort each masked op
takes its unmasked twin's code, so an all-True mask returns the
twin's floats and integers bitwise; an empty cohort divides nothing
by zero.

The sweep's face (``engine.sweep`` stacks n configs of m learners on
one axis of n m rows): ``rows_independent(m)`` says whether
``round_stacked`` over m rows takes a path whose row floats do not
depend on the row count (an engaged kernel with the row alone, and
elementwise code around it), so the configs may share one call and
each row still equals its solo run's bitwise; ``dist_to_ref_grouped``
runs several configs' dynamic checks, each against its own reference,
in one ``quadform`` launch where each config's own check is one.

The mesh's face (``engine.run(mesh=)``, one process driving every
shard): :func:`shard_rows` cuts a stacked tree into contiguous blocks
of learners, one per shard device, and :func:`join_rows` concatenates
the shards' blocks in learner order on one device.  A sharded run
initializes the whole stack and cuts it, so learner ids (the SV
ledger's id sets) stay global.  ``dist_to_ref_each`` is the
reference's per-learner-reference distance (each learner against its
own slice of a stacked reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import accounting, compression, learners, rff, rkhs
from .learners import KernelLearnerState, LearnerConfig, LinearLearnerState
from .rff import RFFLearnerState, RFFSpec
from .rkhs import SVModel
from ..tree import tree_map

_BACKENDS = compression.BACKENDS


def _kops():
    """Lazy import of the kernel face (kernels.ops)."""
    from ..kernels import ops
    return ops


def _rowsum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order, by elementwise
    adds only (zero-padded to a power of two): a row's floats never
    depend on how many rows share the call, on any device."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _gather(models, lids: torch.Tensor):
    """Rows ``lids`` of every field of a stacked NamedTuple model."""
    return type(models)(*(v[lids] for v in models))


def _stack_one(model):
    """One model as a stack of one."""
    return type(model)(*(v[None] for v in model))


def shard_rows(tree, devices: Sequence[torch.device]) -> list:
    """A stacked tree (leading learner axis m, n | m) cut into
    ``n = len(devices)`` contiguous blocks of m / n learners, block k on
    ``devices[k]`` as tensors of its own.  One device: ``[tree]``,
    untouched."""
    n = len(devices)
    if n == 1:
        return [tree]
    return [tree_map(lambda v: v.chunk(n)[k].to(dev, copy=True), tree)
            for k, dev in enumerate(devices)]


def join_rows(trees: Sequence, device: torch.device):
    """The shards' blocks concatenated in learner order on ``device``
    (the reference's tiled ``all_gather``).  One shard: the tree itself."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *v: torch.cat([t.to(device) for t in v]), *trees)


def replicate(tree, devices: Sequence[torch.device]) -> list:
    """One tree copied to every shard's device.  One device: ``[tree]``."""
    if len(devices) == 1:
        return [tree]
    return [tree_map(lambda v: v.to(dev, copy=True), tree) for dev in devices]


def _cohort(mask, device) -> Tuple[torch.Tensor, int]:
    """(mask as a bool tensor on ``device``, cohort size as a host int)."""
    count = int(mask.sum())
    return torch.as_tensor(mask, dtype=torch.bool, device=device), count


class Substrate:
    """Protocol-facing model representation (see module docstring).

    - ``loss``: the surrogate loss ("hinge" | "squared").
    - ``input_dim``: the stream's feature dimension d.
    - ``has_eps``: syncs produce a compression-error series.
    - ``free_divergence``: the divergence is cheap, recorded every round.
    - ``guarded_dist_check``: the dynamic distance is computed only on
      check rounds (the engine decides those on the host anyway).
    """

    loss: str = "hinge"
    has_eps: bool = False
    free_divergence: bool = True
    guarded_dist_check: bool = False

    def on(self, device: torch.device) -> "Substrate":
        """This substrate with its constant tensors on ``device``."""
        return self

    def init(self, m: int, device):
        raise NotImplementedError

    def models_of(self, state):
        return state

    def with_models(self, state, models):
        return models

    def predict(self, models, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_rows(self, picked, Xb: torch.Tensor) -> torch.Tensor:
        """Row i answered by model ``picked[i]`` on input ``Xb[i]``:
        (n, ...) models, (n, d) inputs -> (n,).  Must be row-independent
        (the serving contract, see the module docstring)."""
        raise NotImplementedError

    def predict_batch(self, models, lids: torch.Tensor,
                      Xb: torch.Tensor) -> torch.Tensor:
        """Serve a padded bucket from the stacked models: request i is
        answered by learner ``lids[i]`` on ``Xb[i]`` -> (n,).  Padding
        rows repeat a learner id of the bucket with zero inputs and are
        discarded by the caller.  Row i equals
        ``predict_one(models[lids[i]], Xb[i])`` bitwise."""
        return self.predict_rows(_gather(models, lids), Xb)

    def predict_one(self, model, x: torch.Tensor) -> torch.Tensor:
        """One (unstacked) model on one input (d,) -> scalar."""
        return self.predict_rows(_stack_one(model), x[None])[0]

    def update(self, state, example):
        raise NotImplementedError

    def round_stacked(self, state, example):
        """One stacked round -> (new_state, losses, yhat_pre_update)."""
        yhat = self.predict(self.models_of(state), example[0])
        new_state, losses = self.update(state, example)
        return new_state, losses, yhat

    def average_stacked(self, models):
        """(f_sync, eps): the Prop. 2 average prepared for redistribution."""
        raise NotImplementedError

    def adopt(self, models, fsync):
        raise NotImplementedError

    def dist_to_ref(self, models, ref) -> torch.Tensor:
        raise NotImplementedError

    def dist_to_ref_each(self, models, ref_stacked) -> torch.Tensor:
        """Per-learner distance to a per-learner reference: ``ref_stacked``
        carries the same leading learner axis as ``models`` (the
        reference's stacked Sec. 3 reference).  With every slice equal
        to one reference it equals ``dist_to_ref`` against it."""
        raise NotImplementedError

    def divergence(self, models) -> torch.Tensor:
        raise NotImplementedError

    def ledger_init(self, m: int, device):
        return ()

    def sync_payload(self, models, ledger):
        """Sec. 3 bytes of one synchronization -> (int64 bytes, ledger)."""
        raise NotImplementedError

    def allreduce_sync_bytes(self, m: int) -> int:
        """Total ring bytes of one synchronization under
        ``topology="allreduce"`` (a host constant)."""
        raise NotImplementedError

    def validate(self, T: int, m: int, d: int) -> None:
        if d != self.input_dim:
            raise ValueError(
                f"stream dim {d} != substrate dim {self.input_dim}")

    # -- participation face (see the module docstring) ----------------------

    def average_stacked_masked(self, models, mask):
        """(f_sync, eps): the Prop. 2 average over the cohort only."""
        raise NotImplementedError

    def sync_payload_masked(self, models, mask, ledger):
        """Sec. 3 bytes of one cohort sync -> (bytes, ledger):
        non-participants neither upload nor download and are left out
        of the shipped union."""
        raise NotImplementedError

    def rejoin_payload_bytes(self, models, ref, rejoin):
        """Sec. 3 download bytes of re-adopting ``ref`` on the
        ``rejoin`` (m,) learners (a learner back from churn)."""
        raise NotImplementedError

    def allreduce_sync_bytes_masked(self, count: int) -> int:
        """Ring bytes of one cohort sync: ``allreduce_sync_bytes`` of a
        ring of ``count`` learners (0 for a cohort of 0 or 1)."""
        return self.allreduce_sync_bytes(int(count))

    # -- the sweep's face (see the module docstring) ------------------------

    def rows_independent(self, m: int) -> bool:
        return False

    def dist_to_ref_grouped(self, models: Sequence, refs: Sequence) -> list:
        """``dist_to_ref`` of several configs, each (m, ...) stack
        against its own reference, as a list of (m,) tensors."""
        return [self.dist_to_ref(mo, r) for mo, r in zip(models, refs)]

    # -- node face ----------------------------------------------------------

    def init_node(self, idx: int, device):
        raise NotImplementedError

    def node_model(self, state):
        return state

    def update_one(self, state, example):
        """One learner's update -> (new_state, loss)."""
        raise NotImplementedError

    def dist_one(self, model, ref) -> torch.Tensor:
        """||model - ref||^2, a 0-dim tensor."""
        raise NotImplementedError

    # a substrate whose predict and update share work (the RFF feature
    # map) sets fused_node_round and implements round_one as one
    # computation; otherwise a node round is predict_one + update_one
    fused_node_round: bool = False

    def round_one(self, state, example):
        """One node round -> (new_state, loss, yhat_pre_update)."""
        raise NotImplementedError

    def init_reference(self, device):
        raise NotImplementedError

    def upload_payload(self, bm: accounting.ByteModel, state,
                       known: Set[int]):
        """(model, ids, nbytes) of a learner -> coordinator upload."""
        raise NotImplementedError

    def download_payload_bytes(self, bm: accounting.ByteModel,
                               union: Set[int], receiver_ids: Set[int]) -> int:
        raise NotImplementedError

    def aggregate(self, reference, models: Sequence, weights: Sequence[float]):
        """Staleness-weighted aggregation -> (fsync, eps | None, union)."""
        raise NotImplementedError

    def adopt_node(self, state, fsync):
        raise NotImplementedError

    # -- the asynchronous harness's snapshot hooks (host buffers) -----------

    def snapshot_buffers(self, T: int, m: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def write_snapshot(self, bufs, t: int, i: int, model) -> None:
        raise NotImplementedError

    def divergence_series(self, bufs, device) -> np.ndarray:
        raise NotImplementedError


class NodeOps(NamedTuple):
    """Per-node compute, shared by every node of a run.  ``round`` is
    one learner round -> (new_state, loss, yhat), yhat the pre-update
    prediction the harness measures service errors with."""

    update: Any
    predict: Any
    dist: Any
    round: Any


def node_ops(sub: Substrate) -> NodeOps:
    """The node face as plain callables (the reference jits them)."""
    if sub.fused_node_round:
        rnd = sub.round_one
    else:
        def rnd(state, example):
            yhat = sub.predict_one(sub.node_model(state), example[0])
            new_state, loss = sub.update_one(state, example)
            return new_state, loss, yhat
    return NodeOps(update=sub.update_one, predict=sub.predict_one,
                   dist=sub.dist_one, round=rnd)


# ---------------------------------------------------------------------------
# SV substrate (dual RKHS expansion)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SVSubstrate(Substrate):
    """Budgeted support-vector expansion + device-ledger accounting."""

    lcfg: LearnerConfig = dataclasses.field(default_factory=LearnerConfig)
    sync_budget: int = 0          # 0 -> lcfg.budget
    compress_method: str = compression.DEFAULT_METHOD
    backend: str = "reference"

    has_eps = True
    free_divergence = False
    guarded_dist_check = True

    def __post_init__(self):
        if not self.lcfg.is_kernel:
            raise ValueError("SVSubstrate needs a kernel LearnerConfig")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.sync_budget == 0:
            object.__setattr__(self, "sync_budget", int(self.lcfg.budget))

    @property
    def loss(self) -> str:
        return self.lcfg.loss

    @property
    def input_dim(self) -> int:
        return self.lcfg.dim

    def validate(self, T: int, m: int, d: int) -> None:
        super().validate(T, m, d)
        learners.check_id_capacity(T)

    def init(self, m: int, device) -> KernelLearnerState:
        ids = torch.arange(m, dtype=torch.int32, device=device)
        return learners.init_kernel_state(self.lcfg, ids, device=device)

    def models_of(self, state):
        return state.model

    def with_models(self, state, models):
        return state._replace(model=models)

    def _engaged(self) -> bool:
        """Kernels backend AND the budget reaches the launch threshold."""
        return self.backend == "kernels" and _kops().engages(self.lcfg.budget)

    def predict(self, models: SVModel, x: torch.Tensor) -> torch.Tensor:
        if self._engaged():
            a = rkhs.masked_alpha(models)
            return _kops().sv_predict_spec(self.lcfg.kernel, x, models.sv, a)
        return rkhs.predict(self.lcfg.kernel, models, x[:, None, :])[:, 0]

    def predict_rows(self, picked: SVModel, Xb: torch.Tensor) -> torch.Tensor:
        # engaged: one sv_predict launch for the bucket, a block per row;
        # below the threshold the plain expansion with fixed-order sums
        if self._engaged():
            return self.predict(picked, Xb)
        return rkhs.predict(self.lcfg.kernel, picked, Xb[:, None, :],
                            _rowsum)[:, 0]

    def update(self, state, example):
        return learners.kernel_update(self.lcfg, state, example)

    def round_stacked(self, state, example):
        # one prediction feeds both the loss record and the update
        x, y = example
        yhat = self.predict(state.model, x)
        new_state, losses = learners.kernel_update_from_yhat(
            self.lcfg, state, (x, y), yhat)
        return new_state, losses, yhat

    def average_stacked(self, models: SVModel):
        fbar = rkhs.average_stacked(models)           # budget m * tau
        return compression.compress(self.lcfg.kernel, fbar,
                                    self.sync_budget, self.compress_method,
                                    backend=self.backend)

    def average_stacked_masked(self, models: SVModel, mask):
        # the cohort's slots enter with their coefficients over the cohort
        # size, every other slot with alpha 0 and id -1: the m tau mix
        # compressed under this substrate's backend (under "kernels" one
        # quadform form, no Gram)
        m, tau, d = models.sv.shape
        mask, cnt = _cohort(mask, models.sv.device)
        if cnt == m:
            return self.average_stacked(models)
        keep = mask[:, None] & (models.sv_id >= 0)
        alpha = torch.where(keep, models.alpha / max(cnt, 1),
                            torch.zeros_like(models.alpha))
        sv_id = torch.where(mask[:, None], models.sv_id,
                            torch.full_like(models.sv_id, -1))
        fbar = SVModel(sv=models.sv.reshape(m * tau, d),
                       alpha=alpha.reshape(m * tau),
                       sv_id=sv_id.reshape(m * tau))
        return compression.compress(self.lcfg.kernel, fbar,
                                    self.sync_budget, self.compress_method,
                                    backend=self.backend)

    def sync_payload_masked(self, models: SVModel, mask, ledger):
        mask, cnt = _cohort(mask, models.sv.device)
        if cnt == models.sv.shape[0]:
            return self.sync_payload(models, ledger)
        bm = accounting.ByteModel(dim=self.lcfg.dim)
        return accounting.device_sync_bytes_kernel(bm, models.sv_id, ledger,
                                                   mask=mask)

    def rejoin_payload_bytes(self, models: SVModel, ref: SVModel, rejoin):
        bm = accounting.ByteModel(dim=self.lcfg.dim)
        return accounting.device_rejoin_bytes_kernel(
            bm, ref.sv_id, models.sv_id, rejoin)

    def rows_independent(self, m: int) -> bool:
        # the engaged sv_predict computes a row alone; the update around
        # it is elementwise (kernel_pa's k(x, x) sums over d unless the
        # kernel is gaussian)
        return self._engaged() and (self.lcfg.algo == "kernel_sgd"
                                    or self.lcfg.kernel.kind == "gaussian")

    def dist_to_ref_grouped(self, models, refs):
        # one quadform launch for every config's 2m + 1 forms when each
        # config's own check engages in every group of forms; a form's
        # value does not depend on the forms beside it
        M, N = models[0].sv.shape[1], refs[0].sv.shape[0]
        if not (self.backend == "kernels" and _kops().engages(M)
                and _kops().engages(N)):
            return super().dist_to_ref_grouped(models, refs)
        d = _kops().rkhs_dist_sq_groups_spec(
            self.lcfg.kernel, torch.stack([mo.sv for mo in models]),
            torch.stack([r.sv for r in refs]),
            torch.stack([rkhs.masked_alpha(mo) for mo in models]),
            torch.stack([rkhs.masked_alpha(r) for r in refs]))
        return list(d)

    def adopt(self, models: SVModel, fsync: SVModel) -> SVModel:
        one = rkhs.pad_to_budget(fsync, self.lcfg.budget)
        m = models.sv.shape[0]
        return SVModel(sv=one.sv.expand((m,) + tuple(one.sv.shape)).clone(),
                       alpha=one.alpha.expand(m, -1).clone(),
                       sv_id=one.sv_id.expand(m, -1).clone())

    def dist_to_ref(self, models: SVModel, ref: SVModel) -> torch.Tensor:
        # engage-gated like every kernel branch: the dynamic protocol's
        # sync decisions feed the byte ledger
        if self.backend == "kernels" and _kops().engages(
                self.lcfg.budget, self.sync_budget):
            return self._dist_kernels(models, ref)
        return rkhs.stacked_dist_to(self.lcfg.kernel, models, ref)

    def dist_to_ref_each(self, models: SVModel,
                         ref_stacked: SVModel) -> torch.Tensor:
        # engaged as dist_to_ref: one quadform launch of 3m forms (or
        # one launch a group of forms where the budgets differ); a
        # form's value does not depend on the forms beside it, so an
        # equal stack gives dist_to_ref's floats
        if self.backend == "kernels" and _kops().engages(
                self.lcfg.budget, self.sync_budget):
            return _kops().rkhs_dist_sq_each_spec(
                self.lcfg.kernel, models.sv, ref_stacked.sv,
                rkhs.masked_alpha(models), rkhs.masked_alpha(ref_stacked))
        return rkhs.dist_sq(self.lcfg.kernel, models, ref_stacked)

    def _dist_kernels(self, models: SVModel, ref: SVModel) -> torch.Tensor:
        return _kops().rkhs_dist_sq_spec(
            self.lcfg.kernel, models.sv, ref.sv, rkhs.masked_alpha(models),
            rkhs.masked_alpha(ref))

    def divergence(self, models: SVModel) -> torch.Tensor:
        if self._engaged():
            fbar = rkhs.average_stacked(models)
            return torch.mean(self.dist_to_ref(models, fbar))
        return rkhs.divergence_stacked(self.lcfg.kernel, models)

    def ledger_init(self, m: int, device):
        return accounting.device_ledger_init(m * self.lcfg.budget, device)

    def sync_payload(self, models: SVModel, ledger):
        bm = accounting.ByteModel(dim=self.lcfg.dim)
        return accounting.device_sync_bytes_kernel(bm, models.sv_id, ledger)

    def allreduce_sync_bytes(self, m: int) -> int:
        # a ring all-gather of the m budget-tau stacks; each slot ships
        # its vector + id (B_x) and its coefficient
        bm = accounting.ByteModel(dim=self.lcfg.dim)
        slot = bm.B_x + bm.dtype_bytes
        return accounting.allgather_bytes(self.lcfg.budget * slot, m)

    # -- node face ----------------------------------------------------------

    def init_node(self, idx: int, device) -> KernelLearnerState:
        return learners.init_state(self.lcfg, idx, device=device)

    def node_model(self, state):
        return state.model

    def update_one(self, state, example):
        # computes its own plain prediction (learners.kernel_update), as
        # the reference's unfused node round does
        return learners.update(self.lcfg, state, example)

    def dist_one(self, model: SVModel, ref: SVModel) -> torch.Tensor:
        # engaged: one quadform launch of 3 forms (ops.rkhs_dist_sq at m = 1)
        if self.backend == "kernels" and _kops().engages(model.budget,
                                                          ref.budget):
            return _kops().rkhs_dist_sq_spec(
                self.lcfg.kernel, model.sv[None], ref.sv,
                rkhs.masked_alpha(model)[None], rkhs.masked_alpha(ref))[0]
        return rkhs.dist_sq(self.lcfg.kernel, model, ref)

    def init_reference(self, device) -> SVModel:
        ref, _ = compression.compress(
            self.lcfg.kernel,
            rkhs.empty_model(self.lcfg.budget, self.lcfg.dim, device=device),
            self.sync_budget, self.compress_method, backend=self.backend)
        return ref

    def upload_payload(self, bm, state, known):
        ids = accounting.idset(state.model.sv_id.cpu().numpy())
        return (state.model, ids,
                accounting.kernel_payload_bytes(bm, ids, known))

    def download_payload_bytes(self, bm, union, receiver_ids):
        return accounting.kernel_payload_bytes(bm, union, receiver_ids)

    def aggregate(self, reference, models, weights):
        """Staleness-weighted RKHS aggregation (FedAsync style).

        candidate_k = (1 - w_k) r + w_k f_k; the new reference is the
        mean of the candidates compressed to the sync budget.  In an
        RKHS the convex combination is the concatenation of the
        coefficient-scaled expansions, built on the device; exact-zero
        coefficients are pruned, so with every w_k = 1 the mix holds
        ``rkhs.average_stacked``'s active slots in its order with its
        floats, and compresses to the same model.  The compression
        takes this substrate's backend: under ``"kernels"`` epsilon is
        one quadform form over the 2 n tau slots (no Gram).
        """
        n = len(models)
        assert n == len(weights) and n > 0
        parts = []
        for f, w in zip(models, weights):
            parts.append((reference, 1.0 - w))
            parts.append((f, w))
        mix = _concat_sv(parts)
        # the mean over candidates: a division (not a multiplication by
        # 1/n), as average_stacked divides by m
        mix = mix._replace(alpha=rkhs.divide(mix.alpha, n))
        union = accounting.idset(mix.sv_id.cpu().numpy())
        fsync, eps = compression.compress(
            self.lcfg.kernel, mix, self.sync_budget, self.compress_method,
            backend=self.backend)
        return fsync, float(eps), union

    def adopt_node(self, state, fsync: SVModel):
        return state._replace(model=rkhs.pad_to_budget(fsync,
                                                       self.lcfg.budget))

    def snapshot_buffers(self, T, m):
        tau, d = self.lcfg.budget, self.lcfg.dim
        return {"sv": np.zeros((T, m, tau, d), np.float32),
                "alpha": np.zeros((T, m, tau), np.float32),
                "sv_id": -np.ones((T, m, tau), np.int32)}

    def write_snapshot(self, bufs, t, i, model: SVModel):
        bufs["sv"][t, i] = model.sv.cpu().numpy()
        bufs["alpha"][t, i] = model.alpha.cpu().numpy()
        bufs["sv_id"][t, i] = model.sv_id.cpu().numpy()

    def divergence_series(self, bufs, device):
        return np.asarray([float(self.divergence(SVModel(
            sv=torch.as_tensor(bufs["sv"][t], device=device),
            alpha=torch.as_tensor(bufs["alpha"][t], device=device),
            sv_id=torch.as_tensor(bufs["sv_id"][t], device=device))))
            for t in range(bufs["sv"].shape[0])])


def _concat_sv(parts: Sequence[Tuple[SVModel, float]]) -> SVModel:
    """Concatenate coefficient-scaled expansions; prune exact zeros.

    Each part's coefficients times ``np.float32(w)`` in float32, as the
    reference scales them; a pruned slot (alpha == 0 or inactive) gets
    id -1, zero vector and coefficient +0.
    """
    sv = torch.cat([model.sv for model, _ in parts])
    alpha = torch.cat([model.alpha * float(np.float32(w))
                       for model, w in parts])
    sv_id = torch.cat([model.sv_id for model, _ in parts])
    dead = (alpha == 0.0) | (sv_id < 0)
    return SVModel(
        sv=torch.where(dead[:, None], torch.zeros_like(sv), sv),
        alpha=torch.where(dead, torch.zeros_like(alpha), alpha),
        sv_id=torch.where(dead, torch.full_like(sv_id, -1), sv_id))


# ---------------------------------------------------------------------------
# Primal substrates share the (w, b) average, distance and accounting
# ---------------------------------------------------------------------------


class _PrimalSubstrate(Substrate):
    """Fixed-size (w, b) models: plain mean, Euclidean distance, and a
    fixed ``2 m (num_params) B`` bytes per sync."""

    has_eps = False
    free_divergence = True
    guarded_dist_check = False

    @property
    def num_params(self) -> int:
        raise NotImplementedError

    def _state_cls(self):
        raise NotImplementedError

    def average_stacked(self, models):
        cls = self._state_cls()
        mean = cls(w=torch.mean(models.w, dim=0), b=torch.mean(models.b))
        return mean, torch.zeros((), dtype=torch.float32,
                                 device=models.w.device)

    def average_stacked_masked(self, models, mask):
        # the cohort's weights summed in stacked order over the cohort
        # size; the full cohort takes average_stacked's mean
        m = models.w.shape[0]
        mask, cnt = _cohort(mask, models.w.device)
        if cnt == m:
            return self.average_stacked(models)
        cls = self._state_cls()
        w = torch.sum(torch.where(mask[:, None], models.w,
                                  torch.zeros_like(models.w)), dim=0)
        b = torch.sum(torch.where(mask, models.b, torch.zeros_like(models.b)))
        c = max(cnt, 1)
        return cls(w=w / c, b=b / c), torch.zeros(
            (), dtype=torch.float32, device=models.w.device)

    def sync_payload_masked(self, models, mask, ledger):
        _, cnt = _cohort(mask, models.w.device)
        return accounting.sync_bytes_linear(self.num_params, cnt), ledger

    def rejoin_payload_bytes(self, models, ref, rejoin):
        # dense vectors have no identity structure: one full download
        # per rejoining learner
        _, cnt = _cohort(rejoin, models.w.device)
        return cnt * accounting.linear_payload_bytes(self.num_params)

    def adopt(self, models, fsync):
        cls = self._state_cls()
        return cls(w=fsync.w.expand_as(models.w).clone(),
                   b=fsync.b.expand_as(models.b).clone())

    def dist_to_ref(self, models, ref) -> torch.Tensor:
        return torch.sum((models.w - ref.w) ** 2, dim=-1) + (models.b - ref.b) ** 2

    def dist_to_ref_each(self, models, ref_stacked) -> torch.Tensor:
        # the same expression, the reference broadcast or stacked
        return self.dist_to_ref(models, ref_stacked)

    def divergence(self, models) -> torch.Tensor:
        wbar = torch.mean(models.w, dim=0)
        bbar = torch.mean(models.b)
        return torch.mean(torch.sum((models.w - wbar[None, :]) ** 2, dim=-1)
                          + (models.b - bbar) ** 2)

    def sync_payload(self, models, ledger):
        m = models.w.shape[0]
        return accounting.sync_bytes_linear(self.num_params, m), ledger

    def allreduce_sync_bytes(self, m: int) -> int:
        return accounting.allreduce_bytes(self.num_params, m)

    # -- node face ----------------------------------------------------------

    def dist_one(self, model, ref) -> torch.Tensor:
        return torch.sum((model.w - ref.w) ** 2) + (model.b - ref.b) ** 2

    def upload_payload(self, bm, state, known):
        return (state, set(),
                accounting.linear_payload_bytes(self.num_params,
                                                bm.dtype_bytes))

    def download_payload_bytes(self, bm, union, receiver_ids):
        return accounting.linear_payload_bytes(self.num_params,
                                               bm.dtype_bytes)

    def aggregate(self, reference, models, weights):
        """Mean over candidates (1 - w_k) r + w_k f_k in weight space,
        accumulated in float64 in arrival order, as the reference does
        in numpy (the same IEEE double operations in the same order),
        then rounded to float32."""
        n = len(models)
        assert n == len(weights) and n > 0
        cls = self._state_cls()
        rw, rb = reference.w.double(), reference.b.double()
        w_acc, b_acc = torch.zeros_like(rw), torch.zeros_like(rb)
        for st, wt in zip(models, weights):
            w_acc += (1.0 - wt) * rw + wt * st.w.double()
            b_acc += (1.0 - wt) * rb + wt * st.b.double()
        return cls(w=rkhs.divide(w_acc, n).float(),
                   b=rkhs.divide(b_acc, n).float()), None, set()

    def adopt_node(self, state, fsync):
        cls = self._state_cls()
        return cls(w=fsync.w, b=fsync.b)

    def snapshot_buffers(self, T, m):
        return {"w": np.zeros((T, m, self.num_params - 1), np.float32),
                "b": np.zeros((T, m), np.float32)}

    def write_snapshot(self, bufs, t, i, st):
        bufs["w"][t, i] = st.w.cpu().numpy()
        bufs["b"][t, i] = float(st.b)

    def divergence_series(self, bufs, device):
        # host numpy, as the reference's
        snap_w, snap_b = bufs["w"], bufs["b"]
        wbar = snap_w.mean(axis=1, keepdims=True)      # (T, 1, D)
        bbar = snap_b.mean(axis=1, keepdims=True)      # (T, 1)
        return (((snap_w - wbar) ** 2).sum(-1)
                + (snap_b - bbar) ** 2).mean(axis=1)


@dataclasses.dataclass(frozen=True)
class LinearSubstrate(_PrimalSubstrate):
    """Euclidean weight vectors with fixed-size sync payloads."""

    lcfg: LearnerConfig = dataclasses.field(
        default_factory=lambda: LearnerConfig(algo="linear_sgd"))
    backend: str = "reference"

    def __post_init__(self):
        if self.lcfg.is_kernel:
            raise ValueError("LinearSubstrate needs a linear LearnerConfig")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def loss(self) -> str:
        return self.lcfg.loss

    @property
    def input_dim(self) -> int:
        return self.lcfg.dim

    @property
    def num_params(self) -> int:
        return self.lcfg.dim + 1

    def _state_cls(self):
        return LinearLearnerState

    def init(self, m: int, device) -> LinearLearnerState:
        return learners.init_linear_state(self.lcfg, lead=(m,), device=device)

    def rows_independent(self, m: int) -> bool:
        # the engaged linear step: a warp a learner
        return (self.backend == "kernels" and self.lcfg.algo == "linear_sgd"
                and _kops().engages(m, self.lcfg.dim))

    def predict(self, models, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(models.w * x, dim=-1) + models.b

    def predict_rows(self, picked, Xb: torch.Tensor) -> torch.Tensor:
        return _rowsum(picked.w * Xb) + picked.b

    def update(self, state, example):
        return learners.linear_update(self.lcfg, state, example)

    def round_stacked(self, state, example):
        # linear_sgd's round is the fused primal step with z = x
        x, y = example
        if (self.backend == "kernels" and self.lcfg.algo == "linear_sgd"
                and _kops().engages(x.shape[0], self.lcfg.dim)):
            w_new, b_new, ell, yhat = _kops().fused_primal_step(
                x, y, state.w, state.b, loss=self.loss,
                eta=self.lcfg.eta, lam=self.lcfg.lam)
            return LinearLearnerState(w=w_new, b=b_new), ell, yhat
        yhat = self.predict(state, x)
        new_state, ell = self.update(state, example)
        return new_state, ell, yhat

    def init_node(self, idx: int, device) -> LinearLearnerState:
        return learners.init_state(self.lcfg, idx, device=device)

    def update_one(self, state, example):
        return learners.update(self.lcfg, state, example)

    def init_reference(self, device) -> LinearLearnerState:
        return learners.init_linear_state(self.lcfg, device=device)


@dataclasses.dataclass(frozen=True)
class RFFSubstrate(_PrimalSubstrate):
    """Primal SGD over D random Fourier features.  ``spec`` carries
    (W, b); ``on(device)`` puts them on the device once per run."""

    spec: RFFSpec = dataclasses.field(
        default_factory=lambda: RFFSpec(dim=8, num_features=256))
    eta: float = 0.5
    lam: float = 0.01
    loss: str = "hinge"
    backend: str = "reference"

    def __post_init__(self):
        if self.loss not in ("hinge", "squared"):
            raise ValueError(f"unknown loss {self.loss!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def input_dim(self) -> int:
        return self.spec.dim

    @property
    def num_params(self) -> int:
        return self.spec.num_features + 1

    def _state_cls(self):
        return RFFLearnerState

    def on(self, device: torch.device) -> "RFFSubstrate":
        return dataclasses.replace(self, spec=self.spec.to(device))

    def _params(self, device):
        W, b = rff.rff_params(self.spec)
        return W.to(device), b.to(device)

    def _phi(self, X2d: torch.Tensor, rows: bool = False) -> torch.Tensor:
        """phi over a batch of rows: (n, d) -> (n, D).  Engage-aware:
        under ``"kernels"`` with max(n, D) >= 128 it is one ``rff``
        launch (``ops.rff_features``), below that the plain map, whose
        projection is a fixed-order sum when ``rows`` (the serving
        face).  The engine's engaged round does not come here
        (``fused_primal_step`` featurizes in-kernel)."""
        W, b = self._params(X2d.device)
        if self.backend == "kernels" and _kops().engages(
                X2d.shape[0], self.spec.num_features):
            return _kops().rff_features(X2d, W, b)
        if rows:
            return rff.featurize(self.spec, W, b, X2d, _rowsum)
        return rff.featurize(self.spec, W, b, X2d)

    def init(self, m: int, device) -> RFFLearnerState:
        return rff.init_state(self.spec, lead=(m,), device=device)

    def rows_independent(self, m: int) -> bool:
        # the engaged RFF step: a cluster a learner
        return self.backend == "kernels" and _kops().engages(
            m, self.spec.num_features)

    def predict(self, models, x: torch.Tensor) -> torch.Tensor:
        Z = self._phi(x)                               # (m, D)
        return torch.sum(models.w * Z, dim=-1) + models.b

    def predict_rows(self, picked, Xb: torch.Tensor) -> torch.Tensor:
        # one featurization for the whole bucket, then the row dots
        return _rowsum(picked.w * self._phi(Xb, rows=True)) + picked.b

    def _round_with_features(self, st, Z, y):
        yhat = torch.sum(st.w * Z, dim=-1) + st.b
        ell, g = learners.loss_and_grad(self.loss, yhat, y)
        w = (1.0 - self.eta * self.lam) * st.w - self.eta * g[:, None] * Z
        b = st.b - self.eta * g
        return RFFLearnerState(w=w, b=b), ell, yhat

    def update(self, state, example):
        x, y = example
        new_state, ell, _ = self._round_with_features(state, self._phi(x), y)
        return new_state, ell

    def round_stacked(self, state, example):
        x, y = example
        if self.backend == "kernels" and _kops().engages(
                x.shape[0], self.spec.num_features):
            W, b = self._params(x.device)
            w_new, b_new, ell, yhat = _kops().fused_primal_step(
                x, y, state.w, state.b, W=W, bias=b,
                scale=math.sqrt(2.0 / self.spec.num_features),
                loss=self.loss, eta=self.eta, lam=self.lam)
            return RFFLearnerState(w=w_new, b=b_new), ell, yhat
        # one shared featurize, the exact predict and update expressions
        return self._round_with_features(state, self._phi(x), y)

    def init_node(self, idx: int, device) -> RFFLearnerState:
        return rff.init_state(self.spec, device=device)

    def _node_round(self, state, x, y):
        # one featurization of the row (one rff launch of M = 1 when
        # engaged) feeds the prediction and the update: the stacked
        # round on a stack of one
        new, ell, yhat = self._round_with_features(
            _stack_one(state), self._phi(x[None]), y[None])
        return RFFLearnerState(w=new.w[0], b=new.b[0]), ell[0], yhat[0]

    def update_one(self, state, example):
        new_state, ell, _ = self._node_round(state, *example)
        return new_state, ell

    fused_node_round = True

    def round_one(self, state, example):
        return self._node_round(state, *example)

    def init_reference(self, device) -> RFFLearnerState:
        return rff.init_state(self.spec, device=device)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def substrate_of(learner, *, sync_budget: Optional[int] = None,
                 compress_method: Optional[str] = None,
                 backend: Optional[str] = None) -> Substrate:
    """Resolve a Substrate, LearnerConfig or RFFSpec to a Substrate, with
    the reference's ``None``-sentinel semantics: an explicitly passed
    keyword overrides, ``None`` keeps the substrate's own value (for a
    config: "truncate", "reference", and the learner budget)."""
    overrides = {}
    if sync_budget is not None:
        overrides["sync_budget"] = int(sync_budget)
    if compress_method is not None:
        overrides["compress_method"] = compress_method
    if backend is not None:
        overrides["backend"] = backend

    if isinstance(learner, Substrate):
        if not overrides:
            return learner
        sub = learner
    elif isinstance(learner, LearnerConfig):
        if learner.is_kernel:
            return SVSubstrate(
                lcfg=learner,
                sync_budget=int(sync_budget or learner.budget),
                compress_method=compress_method or compression.DEFAULT_METHOD,
                backend=backend or "reference")
        # linear models have no sync budget / compression: ignored
        return LinearSubstrate(lcfg=learner, backend=backend or "reference")
    elif isinstance(learner, RFFSpec):
        sub = RFFSubstrate(spec=learner)
        if not overrides:
            return sub
    else:
        raise TypeError(
            f"cannot build a substrate from {type(learner).__name__}; pass a "
            "Substrate, LearnerConfig, or RFFSpec")

    fields = {f.name for f in dataclasses.fields(sub)}
    unknown = sorted(set(overrides) - fields)
    if unknown:
        raise ValueError(
            f"{unknown} cannot be applied to {type(sub).__name__}; "
            "configure the substrate directly")
    return dataclasses.replace(sub, **overrides)
