"""Run ``chip_smoke.py``'s phase 21 (``entry``) alone on the card, then
time the async phase's runs at the depths it was cut from.

    python3 tools/entry_probe.py [--defaults]

First ``chip_smoke.run_entry_phase`` with deterministic algorithms on, as
the script has them (``--defaults``: ``async_susy``,
``susy_distributed`` and ``stock_nowcast`` at the reference's default
sizes instead of the phase's cuts); its JSON lines as the script prints
them.  Then ``sv_dynamic``'s sync rounds below round 500 under
``backend="kernels"`` (the rounds an async SV run of that depth must
match), and one ``run_async_simulation`` of each async config at
``FROM_DEPTHS``, its wall seconds and sync rounds: what phase 7's depths
were cut from to pay for phase 21.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data.streams import susy_stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import run_async_simulation  # noqa: E402

#: each async config's depth before phase 21 was added
FROM_DEPTHS = {"async_sv_dynamic": 500, "async_rff_wan": 1000,
               "async_linear_periodic": 50}
#: the scripts the phase cuts, back at the reference's default sizes
DEFAULT_SIZES = ("async_susy", "susy_distributed", "stock_nowcast")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cs.STARTED = time.perf_counter()
    cs.OUT_DIR.mkdir(exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    if "--defaults" in argv:
        cs.ENTRY_SCRIPTS = tuple(
            (name, rel, () if name in DEFAULT_SIZES else args)
            for name, rel, args in cs.ENTRY_SCRIPTS)
    torch.use_deterministic_algorithms(True)
    cs.run_entry_phase(ops, {})

    learners = {name: (learner, m, pcfg)
                for name, learner, m, pcfg, _ in cs.e2e_configs()}
    learner, m, pcfg = learners["sv_dynamic"]
    X, Y = susy_stream(cs.T_ROUNDS, m, d=cs.D_IN, seed=0)
    res = engine.run(learner, pcfg, X[:500], Y[:500], backend="kernels",
                     device="cuda")
    print(json.dumps({"sv_dynamic_sync_rounds_below_500":
                      res.sync_rounds.tolist()}), flush=True)
    for name, learner, m, _, acfg, sys_cfg, _, _ in cs.async_configs():
        T = FROM_DEPTHS[name]
        X, Y = (a[:T] for a in susy_stream(cs.T_ROUNDS, m, d=cs.D_IN,
                                           seed=0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_async_simulation(learner, acfg, X, Y, backend="kernels",
                                   sys_cfg=sys_cfg, record_divergence=False,
                                   device="cuda")
        torch.cuda.synchronize()
        print(json.dumps({"async": name, "T": T, "m": m,
                          "wall_s": time.perf_counter() - t0,
                          "sync_rounds": got.sync_rounds.tolist()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
