"""Where the card's and the CPU's byte ledgers of one async run part.

    python3 tools/async_bytes_probe.py

``examples/torch/async_susy.py``'s "WAN, poly staleness" run (4 SV
learners, budget 64, 200 rounds) through ``run_async_simulation`` on
the card and then on the CPU, from the same seeds.  Prints both runs'
total bytes and sync counts, whether their sync rounds are equal, the
first rounds whose cumulative bytes differ, and the first aggregate
(``SVSubstrate.aggregate``) whose union of support-vector ids or kept
slots differ between the two runs, if one does.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import substrate  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import (AsyncProtocolConfig, SystemConfig,  # noqa: E402
                                 run_async_simulation)

T, M, D = 200, 4, 8


class _AggregateLog:
    """Records each aggregate's union size and kept slots, per run."""

    def __init__(self):
        self.runs: dict = {}
        self.current = None
        self._aggregate = substrate.SVSubstrate.aggregate

    def __call__(self, sub, reference, models, weights):
        fsync, eps, union = self._aggregate(sub, reference, models, weights)
        self.runs.setdefault(self.current, []).append(
            {"n": len(models), "union": len(union),
             "kept": int((fsync.sv_id >= 0).sum())})
        return fsync, eps, union


def main() -> int:
    X, Y = susy_stream(T=T, m=M, d=D, seed=0)
    lcfg = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                         budget=64, kernel=KernelSpec("gaussian", gamma=0.3),
                         dim=D)
    acfg = AsyncProtocolConfig(kind="dynamic", delta=2.0, alpha=0.6,
                               staleness="poly", stale_a=0.5, agg_window=1.0)
    sys_cfg = SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                           straggler_mult=4.0, straggler_prob=0.3,
                           base_latency=0.5, latency_jitter=0.5,
                           bandwidth=1e5)
    log = _AggregateLog()
    substrate.SVSubstrate.aggregate = (
        lambda sub, *a: log(sub, *a))
    res = {}
    for dev in ("cuda", "cpu"):
        log.current = dev
        res[dev] = run_async_simulation(lcfg, acfg, X, Y, sys_cfg=sys_cfg,
                                        record_divergence=False, device=dev)
    card, cpu = res["cuda"], res["cpu"]
    apart = np.nonzero(card.cumulative_bytes != cpu.cumulative_bytes)[0]
    first = next((i for i, (a, b) in enumerate(zip(log.runs["cuda"],
                                                    log.runs["cpu"]))
                  if a != b), None)
    print(json.dumps({
        "total_bytes": {"cuda": int(card.total_bytes),
                        "cpu": int(cpu.total_bytes)},
        "num_syncs": {"cuda": int(card.num_syncs),
                      "cpu": int(cpu.num_syncs)},
        "sync_rounds_equal": bool(np.array_equal(card.sync_rounds,
                                                 cpu.sync_rounds)),
        "first_rounds_bytes_differ": apart[:3].tolist(),
        "aggregates": {k: len(v) for k, v in log.runs.items()},
        "first_aggregate_that_differs": first,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
