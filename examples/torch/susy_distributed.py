"""Fig. 1 reproduction on PyTorch: error/communication trade-off and
communication-over-time, with and without model compression.

The serial oracle (``core.simulation``) on the CUDA card unless
``--device cpu`` is given; prints examples/susy_distributed.py's table.

    python examples/torch/susy_distributed.py [--rounds 1000] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import simulation  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    T, m, d = args.rounds, args.learners, 8
    X, Y = susy_stream(T=T, m=m, d=d, seed=0)

    linear = LearnerConfig(algo="linear_sgd", loss="hinge", eta=0.1,
                           lam=0.001, dim=d)
    kernel = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5,
                           lam=0.01, budget=256,
                           kernel=KernelSpec("gaussian", gamma=0.3), dim=d)
    kernel_small = kernel.__class__(**{**kernel.__dict__, "budget": 48})

    systems = [
        ("linear  x continuous", "linear", linear, ProtocolConfig(kind="continuous")),
        ("linear  x dynamic   ", "linear", linear, ProtocolConfig(kind="dynamic", delta=0.1)),
        ("kernel  x continuous", "kernel", kernel, ProtocolConfig(kind="continuous")),
        ("kernel  x dynamic   ", "kernel", kernel, ProtocolConfig(kind="dynamic", delta=2.0)),
        ("kernel+compress dyn ", "kernel", kernel_small, ProtocolConfig(kind="dynamic", delta=2.0)),
    ]

    print(f"SUSY-like stream: {m} learners x {T} rounds")
    print(f"{'system':22s} {'cum.error':>9s} {'cum.KB':>10s} {'syncs':>6s} "
          f"{'quiescent@':>10s}")
    curves = {}
    for name, fam, lcfg, pcfg in systems:
        run = (simulation.run_linear_simulation if fam == "linear"
               else simulation.run_kernel_simulation)
        res = run(lcfg, pcfg, X, Y, device=dev)
        curves[name] = res
        q = res.quiescence_round
        print(f"{name:22s} {int(res.cumulative_errors[-1]):9d} "
              f"{res.total_bytes / 1024:10.1f} {res.num_syncs:6d} "
              f"{str(q) if q is not None else '-':>10s}")

    # ASCII communication-over-time plot (Fig. 1b)
    print("\ncumulative communication over time (KB):")
    width = 60
    for name in ("kernel  x continuous", "kernel  x dynamic   ",
                 "kernel+compress dyn "):
        c = curves[name].cumulative_bytes / 1024
        pts = c[np.linspace(0, len(c) - 1, width).astype(int)]
        peak = max(1.0, curves["kernel  x continuous"].cumulative_bytes[-1] / 1024)
        bar = "".join("#" if p > peak * (i + 1) / width else "."
                      for i, p in enumerate(pts))
        print(f"{name:22s} |{bar}| {c[-1]:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
