"""Time ``serve_stream`` on the card unmeshed and on a mesh of shards of
one card, each alone in a fresh process state.

    python3 tools/serve_probe.py [SHARDS]

Runs ``chip_smoke.py``'s ``serve_rff_dynamic`` (phase 3's RFF learners,
m 32, D 2048, T 1000, bursty arrivals, continuous batching, 2 slots a
shard) twice each, unmeshed and on ``make_learner_mesh(devices=
["cuda:0"] * SHARDS)`` (default 4), with deterministic algorithms on as
the script has them.  For each run it prints the wall seconds of the
whole ``serve_stream``, of its part before ``serve()`` (building the
engine, scheduling the feedback and the queries) and of ``serve()``
(the event clock: rounds, predict launches, the result), and the
predict launches; for the second pass, the top functions of a
``cProfile`` of the run by their own time.  The first pass warms up.
"""
from __future__ import annotations

import cProfile
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.streams import susy_stream  # noqa: E402
from repro_torch.launch.mesh import make_learner_mesh  # noqa: E402
from repro_torch.serving import (KernelServingEngine, make_arrivals,  # noqa: E402
                                 serve_stream)


def probe(learner, pcfg, X, Y, arrival, kw, mesh, profile: bool) -> None:
    real = KernelServingEngine.serve
    box = {}
    t0 = 0.0

    def serve(eng, tenant=0):
        box["pre"] = time.perf_counter() - t0
        t = time.perf_counter()
        out = real(eng, tenant)
        torch.cuda.synchronize()
        box["serve"] = time.perf_counter() - t
        return out

    KernelServingEngine.serve = serve
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profile:
        prof.enable()
    try:
        res = serve_stream(
            learner, pcfg, X, Y,
            arrivals=make_arrivals(arrival, rate=cs.SERVE_RATE, seed=0),
            backend="kernels", device=None if mesh else "cuda", mesh=mesh,
            **kw)
        torch.cuda.synchronize()
    finally:
        prof.disable()
        KernelServingEngine.serve = real
    print(f"{'mesh x%d' % mesh.size if mesh else 'unmeshed'}: total "
          f"{time.perf_counter() - t0:.3f} s, before serve() "
          f"{box['pre']:.3f} s, serve() {box['serve']:.3f} s, "
          f"{res.launches} predict launches", flush=True)
    if profile:
        pstats.Stats(prof).sort_stats("tottime").print_stats(12)


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 2
    shards = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    torch.use_deterministic_algorithms(True)
    _, e2e, _, arrival, kw = cs.serve_configs()[0]
    learner, m, pcfg = next((lr, m, p) for n, lr, m, p, _ in
                            cs.e2e_configs() if n == e2e)
    X, Y = susy_stream(cs.T_ROUNDS, m, d=cs.D_IN, seed=0)
    print(cs.nvidia_smi(), flush=True)
    for rep in range(2):
        for mesh in (None, make_learner_mesh(devices=["cuda:0"] * shards)):
            probe(learner, pcfg, X, Y, arrival, kw, mesh, profile=rep == 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
