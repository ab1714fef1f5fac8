"""Kernel-quality learning at linear-model communication cost, on PyTorch.

The paper's Sec. 4 'future work': replace the support-vector expansion
with random Fourier features so the model is a fixed-size primal
vector and every synchronization ships O(m D) bytes, however long the
stream runs.  The substrate layer (DESIGN.md Sec. 8) makes this a
one-line swap: the same ``engine.sweep`` / async harness serve SV, RFF
and linear models.  Runs on the CUDA card unless ``--device cpu`` is
given; prints examples/rff_quickstart.py's lines.

  python examples/torch/rff_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.accounting import sync_bytes_linear  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.core.rff import RFFSpec  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.core.substrate import RFFSubstrate, substrate_of  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import (AsyncProtocolConfig, SystemConfig,  # noqa: E402
                                 run_async_simulation)

T, M, D_IN, D_FEAT = 400, 4, 8, 256


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    X, Y = susy_stream(T=T, m=M, d=D_IN, seed=0)
    pcfg = ProtocolConfig(kind="dynamic", delta=2.0)

    sv = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                       budget=128, kernel=KernelSpec("gaussian", gamma=0.3),
                       dim=D_IN)
    rff = RFFSubstrate(spec=RFFSpec(dim=D_IN, num_features=D_FEAT,
                                    gamma=0.3, seed=0))

    # one sweep call, two model representations, same stream
    sweep = engine.sweep([substrate_of(sv), rff], [pcfg, pcfg], X, Y,
                         device=dev)
    for name, res in zip(("sv-128", f"rff-{D_FEAT}"), sweep.results):
        print(f"{name:9s} errors={int(res.cumulative_errors[-1]):4d} "
              f"syncs={res.num_syncs:3d} bytes={res.total_bytes}")

    # the RFF payload is a constant: Cor. 8 strict adaptivity
    res = sweep[1]
    per_sync = sync_bytes_linear(D_FEAT + 1, M)
    rb = np.diff(np.concatenate([[0], res.cumulative_bytes]))
    assert set(rb[rb > 0].tolist()) == {per_sync}
    print(f"every RFF sync costs exactly {per_sync} bytes")

    # identical substrate, event-driven with stragglers
    res_a = run_async_simulation(
        rff, AsyncProtocolConfig(kind="dynamic", delta=2.0), X, Y,
        sys_cfg=SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                             straggler_mult=4.0, straggler_prob=0.3),
        record_divergence=False, device=dev)
    print(f"async: syncs={res_a.num_syncs} bytes={res_a.total_bytes} "
          f"speedup_vs_barrier={res_a.speedup_vs_barrier:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
