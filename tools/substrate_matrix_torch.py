#!/usr/bin/env python3
"""Quick substrate matrix check of the PyTorch port.

Runs every substrate (SV / RFF / linear) x protocol kind
{periodic, dynamic} x backend {reference, kernels} through THREE
drivers of ``repro_torch``: the device-resident engine
(``core.engine.run``), the asynchronous event-driven harness
(``runtime.run_async_simulation``) and the online serving engine
(``serving.serve_stream``), and asserts the invariants of
tools/substrate_matrix.py, with ``kernels`` in place of ``pallas``:

- finite cumulative loss, at least one synchronization;
- byte ledger consistent with the sync count (for the fixed-payload
  substrates, total bytes == num_syncs * 2 m (p+1) B exactly);
- the engine and the zero-latency async run agree on the sync count
  for the fixed-payload substrates (their aggregation is exact);
- the serving replay's protocol view (syncs, bytes) equals the
  engine's for the same stream;
- the kernels backend's ledger (syncs, bytes, cumulative loss) is
  BIT-IDENTICAL to the reference backend's per driver: at these sizes
  (budget 32, D 64, m 3) the engage-aware dispatch
  (``kernels.ops.engages``) runs the reference expressions for every
  predict, update and check, so Def. 1 decisions cannot depend on the
  backend.  Its one engaged call is the SV async aggregate's truncation
  over 2 n tau = 192 slots (one ``quadform`` form a sync), whose
  epsilon enters no decision and no byte count.

One line per cell; exits non-zero if any invariant failed.  Runs on
the CUDA card unless ``--device cpu`` is given.
Usage:  python tools/substrate_matrix_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.accounting import sync_bytes_linear  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.core.rff import RFFSpec  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.core.substrate import (LinearSubstrate,  # noqa: E402
                                        RFFSubstrate, SVSubstrate)
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import (AsyncProtocolConfig, SystemConfig,  # noqa: E402
                                 run_async_simulation)
from repro_torch.serving import serve_stream  # noqa: E402

T, M, D = 80, 3, 8


def substrates():
    kcfg = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                         budget=32, kernel=KernelSpec("gaussian", gamma=0.3),
                         dim=D)
    lcfg = LearnerConfig(algo="linear_sgd", loss="hinge", eta=0.2, lam=0.01,
                         dim=D)
    return [
        ("sv", SVSubstrate(lcfg=kcfg), None),
        ("rff", RFFSubstrate(spec=RFFSpec(dim=D, num_features=64, gamma=0.3,
                                          seed=0)), 64 + 1),
        ("linear", LinearSubstrate(lcfg=lcfg), D + 1),
    ]


def kinds():
    return [
        ("periodic", ProtocolConfig(kind="periodic", period=10),
         AsyncProtocolConfig(kind="periodic", period=10)),
        ("dynamic", ProtocolConfig(kind="dynamic", delta=1.0),
         AsyncProtocolConfig(kind="dynamic", delta=1.0)),
    ]


def _ledger(res):
    return (int(res.num_syncs), int(res.total_bytes),
            float(res.total_loss))


def _run_cell(sub, pcfg, acfg, X, Y, dev):
    """All three drivers for one (substrate, kind, backend) cell."""
    res = engine.run(sub, pcfg, X, Y, device=dev)
    res_a = run_async_simulation(sub, acfg, X, Y, sys_cfg=SystemConfig(),
                                 record_divergence=False, device=dev)
    res_s = serve_stream(sub, pcfg, X, Y, device=dev)
    return res, res_a, res_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    X, Y = susy_stream(T=T, m=M, d=D, seed=0)
    failures = 0
    for sname, sub, num_params in substrates():
        for kname, pcfg, acfg in kinds():
            per_backend = {}
            for backend in ("reference", "kernels"):
                bsub = dataclasses.replace(sub, backend=backend)
                res, res_a, res_s = _run_cell(bsub, pcfg, acfg, X, Y, dev)
                ok = bool(np.isfinite(res.total_loss)
                          and np.isfinite(res_a.total_loss)
                          and res.num_syncs > 0 and res_a.num_syncs > 0
                          and res.total_bytes > 0
                          # serving replays the same stream: same protocol
                          and res_s.num_syncs == res.num_syncs
                          and res_s.total_bytes == res.total_bytes)
                if num_params is not None:
                    per_sync = sync_bytes_linear(num_params, M)
                    ok = ok and res.total_bytes == res.num_syncs * per_sync
                    ok = (ok and
                          res_a.total_bytes == res_a.num_syncs * per_sync)
                    ok = ok and res.num_syncs == res_a.num_syncs
                per_backend[backend] = tuple(
                    _ledger(r) for r in (res, res_a, res_s))
                print(f"substrate={sname} kind={kname} backend={backend} "
                      f"engine_syncs={res.num_syncs} "
                      f"engine_bytes={res.total_bytes} "
                      f"async_syncs={res_a.num_syncs} "
                      f"async_bytes={res_a.total_bytes} "
                      f"serve_syncs={res_s.num_syncs} "
                      f"serve_bytes={res_s.total_bytes} ok={ok}")
                failures += not ok
            parity = per_backend["reference"] == per_backend["kernels"]
            print(f"substrate={sname} kind={kname} "
                  f"backend_ledger_bitwise_equal={parity}")
            failures += not parity
    print(f"substrate_matrix: {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
