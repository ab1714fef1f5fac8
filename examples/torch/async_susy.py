"""Sync vs. async on the SUSY-like stream, on PyTorch: what latency and
stragglers do to the dynamic protocol, and what staleness weighting buys
back.

``sim-wall``, ``barrier`` and ``speedup`` are the seeded event clock's
values, not wall time.  Runs on the CUDA card unless ``--device cpu``
is given; prints examples/async_susy.py's table.

    python examples/torch/async_susy.py [--rounds 600] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import simulation  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import (AsyncProtocolConfig, SystemConfig,  # noqa: E402
                                 run_async_simulation)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    T, m, d = args.rounds, args.learners, 8
    X, Y = susy_stream(T=T, m=m, d=d, seed=0)
    lcfg = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                         budget=64, kernel=KernelSpec("gaussian", gamma=0.3),
                         dim=d)
    delta = 2.0

    print(f"SUSY-like stream: {m} kernel learners x {T} rounds "
          f"(dynamic protocol, Delta={delta})\n")
    hdr = (f"{'system':34s} {'cum.err':>8s} {'KB':>8s} {'syncs':>6s} "
           f"{'sim-wall':>9s} {'barrier':>8s} {'speedup':>8s}")
    print(hdr)
    print("-" * len(hdr))

    res = simulation.run_kernel_simulation(
        lcfg, ProtocolConfig(kind="dynamic", delta=delta), X, Y, device=dev)
    print(f"{'serial lockstep (paper driver)':34s} "
          f"{int(res.cumulative_errors[-1]):8d} {res.total_bytes/1024:8.1f} "
          f"{res.num_syncs:6d} {'-':>9s} {'-':>8s} {'-':>8s}")

    wan = dict(base_latency=0.5, latency_jitter=0.5, bandwidth=1e5)
    systems = [
        ("async / ideal network (= serial)",
         AsyncProtocolConfig(kind="dynamic", delta=delta),
         SystemConfig(seed=0)),
        ("async / WAN, constant weights",
         AsyncProtocolConfig(kind="dynamic", delta=delta, alpha=0.6,
                             staleness="constant", agg_window=1.0),
         SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                      straggler_mult=4.0, straggler_prob=0.3, **wan)),
        ("async / WAN, poly staleness",
         AsyncProtocolConfig(kind="dynamic", delta=delta, alpha=0.6,
                             staleness="poly", stale_a=0.5, agg_window=1.0),
         SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                      straggler_mult=4.0, straggler_prob=0.3, **wan)),
        ("async / WAN + 5% message loss",
         AsyncProtocolConfig(kind="dynamic", delta=delta, alpha=0.6,
                             staleness="poly", stale_a=0.5, agg_window=1.0),
         SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                      straggler_mult=4.0, straggler_prob=0.3,
                      drop_prob=0.05, **wan)),
    ]
    for name, acfg, sc in systems:
        r = run_async_simulation(lcfg, acfg, X, Y, sys_cfg=sc,
                                 record_divergence=False, device=dev)
        print(f"{name:34s} {int(r.cumulative_errors[-1]):8d} "
              f"{r.total_bytes/1024:8.1f} {r.num_syncs:6d} "
              f"{r.wall_clock:9.1f} {r.barrier_wall_clock:8.1f} "
              f"{r.speedup_vs_barrier:8.2f}")

    print("\nThe ideal-network async run reproduces the serial ledger "
          "byte-for-byte; under WAN latency + intermittent stragglers the "
          "event-driven runtime finishes the same streams faster than any "
          "lockstep schedule on the identical compute draws, and staleness "
          "weighting keeps stale straggler models from dragging the "
          "reference around.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
