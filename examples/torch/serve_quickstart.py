"""Serve online kernel learners while they learn, on PyTorch (DESIGN.md
Secs. 10, 13).

Four distributed learners answer predict requests from a shared
request queue, apply labeled feedback as online updates the moment it
arrives, and run the paper's dynamic synchronization protocol in the
background: latency percentiles and Sec. 3 sync bytes metered on one
seeded timeline.  The protocol view is bit-identical to the engine
(``engine.run``) on the same stream and device; swap the substrate
(SV / RFF / linear) and the same serving path serves it.

The second half shows continuous batching (Sec. 13): Poisson arrivals
served by the ``"continuous"`` policy launch on arrival instead of at
tick-grid points (lower p99 at the same load), and a bounded queue
sheds (or defers) when offered load exceeds simulated capacity,
without the protocol view moving a bit.  Runs on the CUDA card unless
``--device cpu`` is given; prints examples/serve_quickstart.py's lines.

  python examples/torch/serve_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.core.rff import RFFSpec  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.core.substrate import RFFSubstrate  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import SystemConfig  # noqa: E402
from repro_torch.serving import make_arrivals, serve_stream  # noqa: E402

T, M, D = 400, 4, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    X, Y = susy_stream(T=T, m=M, d=D, seed=0)
    pcfg = ProtocolConfig(kind="dynamic", delta=2.0)
    sys_cfg = SystemConfig(seed=0, compute_jitter=0.3, base_latency=0.05,
                           bandwidth=1e7)

    sv = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                       budget=64, kernel=KernelSpec("gaussian", gamma=0.3),
                       dim=D)
    rff = RFFSubstrate(spec=RFFSpec(dim=D, num_features=256, gamma=0.3,
                                    seed=0))

    for name, learner in (("sv-64", sv), ("rff-256", rff)):
        res = serve_stream(learner, pcfg, X, Y, queries_per_round=4.0,
                           sys_cfg=sys_cfg, device=dev)
        pct = res.latency_percentiles()
        print(f"{name:8s} served {res.num_requests} requests over "
              f"{res.rounds} online rounds: "
              f"p50={pct['p50']:.2f} p99={pct['p99']:.2f} (sim time units), "
              f"syncs={res.num_syncs} bytes={res.total_bytes}")

        # the serving path IS the engine, protocol-wise
        ref = engine.run(learner, pcfg, X, Y, device=dev)
        assert np.array_equal(ref.cumulative_loss, res.sim.cumulative_loss)
        assert np.array_equal(ref.cumulative_bytes, res.sim.cumulative_bytes)
        print(f"{'':8s} ... protocol view bit-identical to engine.run "
              f"(loss={res.total_loss:.1f})")

    # batches pay: the engine answered from padded static-size buckets
    res = serve_stream(sv, pcfg, X, Y, queries_per_round=8.0,
                       sys_cfg=sys_cfg, device=dev)
    print("bucket histogram (size -> batches):",
          dict(sorted(res.bucket_counts.items())))

    # --- continuous batching under a latency SLO (Sec. 13) -------------
    lin = LearnerConfig(algo="linear_sgd", loss="hinge", eta=0.1,
                        lam=0.001, dim=D)
    kw = dict(sys_cfg=sys_cfg, predict_cost=0.05, tick_interval=0.25,
              slots=2, device=dev)
    ref = engine.run(lin, pcfg, X, Y, device=dev)
    print()
    for policy in ("tick", "continuous"):
        res = serve_stream(lin, pcfg, X, Y,
                           arrivals=make_arrivals("poisson", rate=6.0,
                                                  seed=0),
                           policy=policy, slo=0.3, **kw)
        pct = res.latency_percentiles()
        assert np.array_equal(ref.cumulative_loss, res.sim.cumulative_loss)
        print(f"{policy:10s} p50={pct['p50']:.3f} p99={pct['p99']:.3f} "
              f"launches={res.launches} (protocol view unchanged)")

    # overload: bursty arrivals past simulated capacity; a bounded
    # queue sheds, served requests keep their SLO, the models don't move
    res = serve_stream(lin, pcfg, X, Y,
                       arrivals=make_arrivals("bursty", rate=30.0, seed=0),
                       policy="continuous", slo=0.3, max_queue=8,
                       overload="shed", **kw)
    assert np.array_equal(ref.cumulative_loss, res.sim.cumulative_loss)
    print(f"overloaded  served={res.num_requests} shed={res.num_shed} "
          f"p99={res.latency_percentiles()['p99']:.3f} "
          f"(feedback never shed -> parity holds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
