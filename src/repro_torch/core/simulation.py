"""Run results (port of ``repro/core/simulation.py:35-93``).

The serial loop oracle of the reference is not ported yet
(ROADMAP.md); the engine builds its result through
``SimResult.from_round_series`` exactly as the reference's engine does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SimResult:
    """Everything the figure benchmarks need."""

    cumulative_loss: np.ndarray        # (T,) summed over learners
    cumulative_bytes: np.ndarray       # (T,)
    cumulative_errors: np.ndarray      # (T,) 0/1 prediction mistakes
    sync_rounds: np.ndarray            # indices where a sync happened
    divergences: np.ndarray            # (T,) measured delta(f_t)
    eps_history: np.ndarray            # compression errors at syncs
    num_syncs: int
    total_bytes: int
    total_loss: float

    @property
    def quiescence_round(self) -> Optional[int]:
        """First round from which the run is synchronization-free through
        the end: 0 without syncs, ``s + 1`` after a last sync at
        ``s < T - 1``, None when a sync landed on the final round."""
        if len(self.sync_rounds) == 0:
            return 0
        last = int(self.sync_rounds[-1])
        T = len(self.cumulative_loss)
        return last + 1 if last + 1 <= T - 1 else None

    @classmethod
    def from_round_series(
        cls,
        losses: np.ndarray,       # (T,) per-round summed loss
        errors: np.ndarray,       # (T,) per-round summed errors
        round_bytes: np.ndarray,  # (T,) bytes charged per round
        divergences: np.ndarray,  # (T,) or (0,) measured delta(f_t)
        sync_flags: np.ndarray,   # (T,) bool, True where a sync happened
        eps: np.ndarray,          # (T,) or (0,) compression error per round
    ) -> "SimResult":
        """Accumulate per-round series on the host in float64/int64."""
        losses = np.asarray(losses, np.float64)
        errors = np.asarray(errors, np.float64)
        sync_flags = np.asarray(sync_flags, bool)
        cum_bytes = np.cumsum(np.asarray(round_bytes, np.int64))
        cum_loss = np.cumsum(losses)
        return cls(
            cumulative_loss=cum_loss,
            cumulative_bytes=cum_bytes,
            cumulative_errors=np.cumsum(errors),
            sync_rounds=np.nonzero(sync_flags)[0].astype(np.int64),
            divergences=np.asarray(divergences, np.float64),
            eps_history=(np.asarray(eps, np.float64)[sync_flags]
                         if len(eps) else np.zeros((0,))),
            num_syncs=int(sync_flags.sum()),
            total_bytes=int(cum_bytes[-1]) if len(cum_bytes) else 0,
            total_loss=float(cum_loss[-1]) if len(cum_loss) else 0.0,
        )
