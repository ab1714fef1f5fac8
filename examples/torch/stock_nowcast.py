"""Fig. 2 reproduction on PyTorch: 32 learners nowcast a stock's
next-step return.

Linear vs Gaussian-kernel learners (budget 100, truncation), periodic
vs dynamic synchronization, through the serial oracle
(``core.simulation``) on the CUDA card unless ``--device cpu`` is
given; prints examples/stock_nowcast.py's table.

    python examples/torch/stock_nowcast.py [--rounds 1200] [--device cpu]
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
from repro_torch.data import stock_stream  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1200)
    ap.add_argument("--learners", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    T, m, d = args.rounds, args.learners, 10
    X, Y = stock_stream(T=T, m=m, d=d, seed=0)

    linear = LearnerConfig(algo="linear_sgd", loss="squared", eta=0.05,
                           lam=1e-4, dim=d)
    kernel = LearnerConfig(algo="kernel_sgd", loss="squared", eta=0.5,
                           lam=1e-3, budget=100,
                           kernel=KernelSpec("gaussian", gamma=0.2), dim=d)

    print(f"stock stream: {m} learners x {T} rounds")
    print(f"{'system':24s} {'cum.sq.err':>11s} {'cum.KB':>10s} {'syncs':>6s}")
    res = {}
    for name, fam, lcfg, pcfg in [
        ("linear  x periodic(10)", "lin", linear, ProtocolConfig(kind="periodic", period=10)),
        ("kernel  x periodic(10)", "ker", kernel, ProtocolConfig(kind="periodic", period=10)),
        ("kernel  x dynamic     ", "ker", kernel, ProtocolConfig(kind="dynamic", delta=2.0)),
    ]:
        run = (simulation.run_linear_simulation if fam == "lin"
               else simulation.run_kernel_simulation)
        r = run(lcfg, pcfg, X, Y, device=dev)
        res[name] = r
        print(f"{name:24s} {r.cumulative_errors[-1]:11.1f} "
              f"{r.total_bytes/1024:10.1f} {r.num_syncs:6d}")

    err_red = (res["linear  x periodic(10)"].cumulative_errors[-1]
               / res["kernel  x dynamic     "].cumulative_errors[-1])
    comm_red = (res["kernel  x periodic(10)"].total_bytes
                / max(res["kernel  x dynamic     "].total_bytes, 1))
    print(f"\nkernel+dynamic vs linear: error reduced {err_red:.1f}x "
          f"(paper: ~18x on real data)")
    print(f"dynamic vs periodic kernel: communication reduced {comm_red:.1f}x "
          f"(paper: ~2433x on real data)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
