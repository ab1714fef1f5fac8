"""Byte-exact communication accounting, paper Sec. 3 (port of
``repro/core/accounting.py``).

Designated-coordinator topology with the trivial reduction strategy:

  upload  (learner i -> coordinator):  |S_t^i| B_alpha  +  |S_t^i \\ Sbar_{t'}| B_x
  download(coordinator -> learner i):  |Sbar_t| B_alpha +  |Sbar_t \\ S_t^i| B_x

Linear and random-feature models pay m uploads + m downloads of a
fixed-size vector.  ``kernel_payload_bytes`` / ``linear_payload_bytes``
size one message of the asynchronous runtime (a link's share of the
same sums).  ``allreduce_bytes`` / ``allgather_bytes`` price the ring
collectives of ``topology="allreduce"``.

``device_sync_bytes_kernel`` runs the same set algebra on the device
over sorted int32 id arrays, over every learner or a participating
cohort (``mask=``); ``device_rejoin_bytes_kernel`` prices a rejoining
learner's download of the reference.  The port keeps the byte count in int64,
but refuses exactly the shapes the reference's int32 guard refuses
(``repro/core/accounting.py:215``), so the two packages accept the
same runs.  The host ``sync_bytes_kernel`` / ``CommunicationLedger``
stay as the oracle the device ledger is tested against.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import rkhs


@dataclasses.dataclass(frozen=True)
class ByteModel:
    """B_x = bytes per support vector (O(d)); B_alpha per coefficient."""

    dim: int
    dtype_bytes: int = 4
    id_bytes: int = 4

    @property
    def B_x(self) -> int:
        # vector payload + its id tag
        return self.dim * self.dtype_bytes + self.id_bytes

    @property
    def B_alpha(self) -> int:
        # coefficient + the id it belongs to
        return self.dtype_bytes + self.id_bytes


def idset(ids: np.ndarray) -> set:
    """Active sv_id set of an id array (negative = empty slot)."""
    ids = np.asarray(ids).reshape(-1)
    return set(int(i) for i in ids if i >= 0)


def sync_bytes_kernel(bm: ByteModel, local_ids: Sequence[np.ndarray],
                      coordinator_known: set) -> tuple[int, set]:
    """Host oracle: bytes for one kernel-model sync and the new
    coordinator cache Sbar_t."""
    sets = [idset(a) for a in local_ids]
    union = set().union(*sets) if sets else set()
    total = 0
    for s in sets:
        total += len(s) * bm.B_alpha + len(s - coordinator_known) * bm.B_x
        total += len(union) * bm.B_alpha + len(union - s) * bm.B_x
    return total, union


def sync_bytes_linear(num_params: int, m: int, dtype_bytes: int = 4) -> int:
    """m uploads + m downloads of a fixed-size weight vector (also the
    RFF substrate's cost with num_params = D + 1)."""
    return 2 * m * num_params * dtype_bytes


def kernel_payload_bytes(bm: ByteModel, send_ids: set,
                         receiver_known: set) -> int:
    """Bytes to ship an expansion over ``send_ids`` to a receiver that
    already caches ``receiver_known``: every coefficient, only novel
    support vectors (the Sec. 3 delta encoding of one link)."""
    return (len(send_ids) * bm.B_alpha
            + len(send_ids - receiver_known) * bm.B_x)


def linear_payload_bytes(num_params: int, dtype_bytes: int = 4) -> int:
    """Dense weight vectors have no identity structure: full re-send."""
    return num_params * dtype_bytes


def allreduce_bytes(num_params: int, m: int, dtype_bytes: int = 4) -> int:
    """TOTAL ring bytes of one all-reduce: ``2 (m-1) |theta| B``."""
    if m <= 1:
        return 0
    return int(2 * (m - 1) * num_params * dtype_bytes)


def allgather_bytes(shard_bytes: int, m: int) -> int:
    """TOTAL ring bytes of one all-gather of m shards: ``m (m-1) shard``."""
    if m <= 1:
        return 0
    return int(m * (m - 1) * shard_bytes)


# ---------------------------------------------------------------------------
# Device-resident ledger
# ---------------------------------------------------------------------------


class DeviceLedger(NamedTuple):
    """The coordinator cache on the device: ``known`` is the sorted-unique
    int32 id array of Sbar_{t'}, padded with ``rkhs.ID_SENTINEL``, of
    fixed capacity m * tau."""

    known: torch.Tensor


def device_ledger_init(capacity: int, device=None) -> DeviceLedger:
    """Fresh coordinator cache (nothing known — first sync ships all)."""
    return DeviceLedger(known=torch.full(
        (capacity,), rkhs.ID_SENTINEL, dtype=torch.int32, device=device))


#: The reference holds per-sync bytes in int32; the port refuses the
#: same shapes so both packages accept the same runs.
INT32_LIMIT = 2**31


def check_kernel_sync_capacity(bm: ByteModel, m: int, tau: int) -> None:
    """Refuse the shapes whose worst-case per-sync bytes reach 2**31
    (every learner ships tau distinct vectors and downloads a full
    m * tau union), exactly as the reference's guard does."""
    worst = m * tau * (bm.B_alpha + bm.B_x) * (m + 1)
    if worst >= INT32_LIMIT:
        raise ValueError(
            f"per-sync bytes can reach {worst} for m={m}, tau={tau}, "
            f"d={bm.dim}, which overflows the reference device ledger's "
            "int32; use the host CommunicationLedger at this scale")


def device_sync_bytes_kernel(bm: ByteModel, stacked_ids: torch.Tensor,
                             ledger: DeviceLedger,
                             mask: torch.Tensor | None = None,
                             ) -> tuple[torch.Tensor, DeviceLedger]:
    """Bytes (int64 0-dim tensor) for one kernel-model sync and the
    ledger with known = Sbar_t.

    Per learner i with distinct active set s_i, cache K and union U
    (s_i ⊆ U, so |U \\ s_i| = |U| - |s_i|):

      upload   |s_i| B_alpha + |s_i \\ K| B_x
      download |U| B_alpha + (|U| - |s_i|) B_x

    ``mask`` (m,) bool restricts the sync to a participating cohort:
    a non-participant's id row becomes the empty set (it neither
    uploads nor downloads nor adds to the union), the downloaders are
    the cohort, and ``known`` becomes the cohort's union.  A mask only
    shrinks the cohort, so the full-m guard covers it.
    """
    m, tau = stacked_ids.shape
    check_kernel_sync_capacity(bm, m, tau)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool,
                               device=stacked_ids.device)
        stacked_ids = torch.where(mask[:, None], stacked_ids,
                                  torch.full_like(stacked_ids, -1))
        downloaders = torch.sum(mask.to(torch.int64))
    else:
        downloaders = m
    uniq, n = rkhs.sorted_unique_rows(stacked_ids)         # (m, tau), (m,)
    union, u = rkhs.sorted_unique(uniq)                     # (m*tau,), ()
    in_known = rkhs.count_members(uniq, ledger.known)       # (m,)
    n = n.to(torch.int64)
    u = u.to(torch.int64)
    n_total = torch.sum(n)
    total = (n_total * bm.B_alpha
             + torch.sum(n - in_known.to(torch.int64)) * bm.B_x
             + downloaders * u * bm.B_alpha
             + (downloaders * u - n_total) * bm.B_x)
    cap = ledger.known.shape[0]
    if union.shape[0] != cap:
        raise ValueError(
            f"union capacity {union.shape[0]} != ledger capacity {cap}")
    return total, DeviceLedger(known=union)


def device_rejoin_bytes_kernel(bm: ByteModel, ref_ids: torch.Tensor,
                               stacked_ids: torch.Tensor,
                               rejoin: torch.Tensor) -> torch.Tensor:
    """Sec. 3 download bytes (int64 0-dim tensor) of re-adopting the
    reference on the ``rejoin`` (m,) bool learners: per rejoiner i
    with id set s_i and the reference's distinct id set R, one
    delta-encoded message ``|R| B_alpha + |R \\ s_i| B_x``
    (``kernel_payload_bytes`` on the host).  Refuses the shapes the
    reference's int32 guard refuses."""
    m, tau = stacked_ids.shape
    worst = m * max(int(ref_ids.reshape(-1).shape[0]), tau) \
        * (bm.B_alpha + bm.B_x)
    if worst >= INT32_LIMIT:
        raise ValueError(
            f"per-round rejoin bytes can reach {worst} for m={m}, "
            "which overflows the reference's int32 byte column; use the "
            "host accounting at this scale")
    rejoin = torch.as_tensor(rejoin, dtype=torch.bool,
                             device=stacked_ids.device)
    ref_uniq, ref_n = rkhs.sorted_unique(ref_ids)            # (R,), ()
    rows, _ = rkhs.sorted_unique_rows(stacked_ids)           # (m, tau)
    # |R ∩ s_i|: R's ids searched in each learner's sorted row
    q = ref_uniq.expand(m, -1).contiguous()
    idx = torch.clamp(torch.searchsorted(rows, q), 0, tau - 1)
    hit = (torch.gather(rows, 1, idx) == q) & (q < rkhs.ID_SENTINEL)
    overlap = torch.sum(hit.to(torch.int64), dim=-1)
    ref_n = ref_n.to(torch.int64)
    per = ref_n * bm.B_alpha + (ref_n - overlap) * bm.B_x
    return torch.sum(torch.where(rejoin, per, torch.zeros_like(per)))


class CommunicationLedger:
    """Running C(T, m) on the host (the oracle of the device ledger)."""

    def __init__(self, bm: ByteModel):
        self.bm = bm
        self.coordinator_known: set = set()
        self.total = 0
        self.rounds: list[int] = []
        self.sync_rounds: list[int] = []

    def record_no_sync(self) -> None:
        self.rounds.append(0)

    def record_kernel_sync(self, local_ids: Sequence[np.ndarray], t: int) -> int:
        b, known = sync_bytes_kernel(self.bm, local_ids, self.coordinator_known)
        self.coordinator_known = known
        self.total += b
        self.rounds.append(b)
        self.sync_rounds.append(t)
        return b

    def record_linear_sync(self, num_params: int, m: int, t: int) -> int:
        b = sync_bytes_linear(num_params, m, self.bm.dtype_bytes)
        self.total += b
        self.rounds.append(b)
        self.sync_rounds.append(t)
        return b

    @property
    def cumulative(self) -> np.ndarray:
        return np.cumsum(np.asarray(self.rounds, dtype=np.int64))
