"""Compare the port's per-round kernels across trees, on one card.

    python3 tools/kernel_ab.py NAME=PATH [NAME=PATH ...] --order a,b,b,a

Each PATH is a directory holding ``src/repro_torch``: ``.`` for this
checkout, or an earlier commit unpacked with ``git archive COMMIT
src/repro_torch | tar -x -C PATH`` (into a directory .gitignore lists).
For every name of ``--order``, in that order, a fresh process imports
that tree's package (which builds its kernels into its own
``kernels/build/``; one kernel library a process, as the profiler
drops kernel events once a second one is loaded) and measures on the
same seeded inputs:

- ``sv_predict`` gaussian at (B 32, N 1024, d 18) and at B 8, the RFF
  ``primal_step`` at (B 32, D 2048, d 18), the linear one at (B 1024,
  d 18), ``rff`` at serving's buckets of M = 16, 32 and 64 rows (D 2048,
  d 18; a bucket the first M rows of a 64-row X) and the dynamic
  check's ``ops.rkhs_dist_sq`` (m = 32 learners against one model,
  budget 1024, d 18; ``dist_check``): ``ms`` and ``device_ms`` as
  ``chip_smoke.time_ms`` gives them, and the same with the operands
  copied to start 4 bytes past a 16-byte boundary (``*_off16``);
- ``gram`` at the SV sync's shape (M = N = 32768, d 18), gaussian and
  linear, and the sync's epsilon^2 = beta^T K beta over those rows by
  its two kernel routes: one ``quadform`` form (``sync_quadform``) and
  the ``gram`` kernel's buffer under the plain form (``sync_gram``),
  both built from ``ops`` and ``core.rkhs`` names every tree has;
  beside them ``torch.matmul(X, Y.T)``, the linear kind's library call
  (timed only);
- ``engine.run`` of ``chip_smoke.py``'s ``sv_periodic``, ``sv_dynamic``
  and ``rff_dynamic`` at full width, twice each with ``backend="kernels"``
  and with ``backend="reference"``, alternating: rounds per second, and
  the host seconds per call spent inside the kernel wrappers
  (``fused.sv_predict`` / ``fused.primal_step``, no synchronize added).

Each visit also gives a checksum of the outputs of the linear step, of
``rff`` at each bucket (and off 16 bytes), of the dynamic check, of
``gram`` (both kinds) and of the sync's form on its inputs (the int64 sum
of the output floats' bit patterns): equal checksums across trees say
that a redesign kept a kernel's floats.

One JSON line per tree visit, after the card's ``nvidia-smi`` name and
power limit; the lines also go to ``kernel_ab.jsonl`` in chip_smoke.py's
output directory (``chip_smoke.OUT_DIR``).
Alternate the trees (a, b, b, a) so that a drift of the host shows.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

E2E_RUNS = ("sv_periodic", "sv_dynamic", "rff_dynamic")
WRAPPERS = {"sv_periodic": "sv_predict", "sv_dynamic": "sv_predict",
            "rff_dynamic": "primal_step"}
DEVICE = "cuda"


def inputs(dev) -> dict:
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    d, D = chip_smoke.D_IN, chip_smoke.N_FEATURES
    return {
        "sv": (randn(32, d), randn(32, 1024, d), randn(32, 1024)),
        "rff": ((randn(32, d), torch.sign(randn(32)), 0.1 * randn(32, D),
                 randn(32)),
                dict(W=0.3 * randn(D, d), bias=randn(D),
                     scale=(2.0 / D) ** 0.5)),
        "linear": (randn(1024, d), torch.sign(randn(1024)),
                   0.1 * randn(1024, d), randn(1024)),
        "rff_bucket": (randn(64, d), 0.3 * randn(D, d), 6.0 * randn(D)),
        "dist": (randn(chip_smoke.M_KERNEL, chip_smoke.BUDGET, d),
                 randn(chip_smoke.BUDGET, d),
                 randn(chip_smoke.M_KERNEL, chip_smoke.BUDGET),
                 randn(chip_smoke.BUDGET)),
    }


def kernel_times(fused, x) -> dict:
    X, SV, A = x["sv"]
    kw = dict(kind="gaussian", gamma=chip_smoke.GAMMA)
    args, rkw = x["rff"]
    calls = {
        "sv_predict": lambda: fused.sv_predict(X, SV, A, **kw),
        "sv_predict_b8": lambda: fused.sv_predict(X[:8], SV[:8], A[:8], **kw),
        "primal_step_rff": lambda: fused.primal_step(*args, **rkw),
        "primal_step_linear": lambda: fused.primal_step(*x["linear"]),
    }
    SVo, Ao, Wo = (chip_smoke.off16(t) for t in (SV, A, rkw["W"]))
    calls.update({
        "sv_predict_off16": lambda: fused.sv_predict(X, SVo, Ao, **kw),
        "primal_step_rff_off16": lambda: fused.primal_step(
            *args, **dict(rkw, W=Wo)),
    })
    from repro_torch.kernels import ops, rff
    Xr, Wr, br = x["rff_bucket"]
    for M in (16, 32, 64):
        Xm, Xo = Xr[:M], chip_smoke.off16(Xr[:M])
        calls[f"rff_m{M}"] = lambda Xm=Xm: rff.rff(Xm, Wr, br)
        calls[f"rff_m{M}_off16"] = lambda Xo=Xo: rff.rff(Xo, Wr, br)
    calls["dist_check"] = lambda: ops.rkhs_dist_sq(*x["dist"], kind="gaussian",
                                                   gamma=chip_smoke.GAMMA)
    out = {name: chip_smoke.time_ms(fn) for name, fn in calls.items()}
    out["checksums"] = {}
    for name in calls:
        if name == "primal_step_linear" or name.startswith(("rff_", "dist")):
            res = calls[name]()
            out["checksums"][name] = checksum(
                *(res if isinstance(res, tuple) else (res,)))
    return out


def checksum(*tensors) -> int:
    """The int64 sum of the float32 outputs' bit patterns."""
    return sum(int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))
               for t in tensors)


def sync_times(dev) -> dict:
    """``gram`` and the two routes of the sync's form at full size."""
    from repro_torch.core import rkhs
    from repro_torch.kernels import gram, ops

    gen = torch.Generator().manual_seed(1)
    M, d = chip_smoke.GRAM_M, chip_smoke.D_IN
    X = torch.randn(M, d, generator=gen).to(dev)
    Y = torch.randn(M, d, generator=gen).to(dev)
    beta = (torch.randn(M, generator=gen) / chip_smoke.M_KERNEL).to(dev)
    beta[:chip_smoke.BUDGET] = 0.0            # the kept slots
    spec = rkhs.KernelSpec("gaussian", gamma=chip_smoke.GAMMA)
    calls = {
        "gram_gaussian": lambda: gram.gram(X, Y, kind="gaussian",
                                           gamma=chip_smoke.GAMMA),
        "gram_linear": lambda: gram.gram(X, Y, kind="linear"),
        "sync_quadform": lambda: ops.quadform_spec(
            spec, X[None], X[None], beta[None], beta[None]),
        "sync_gram": lambda: rkhs.quadform_(ops.gram_spec(spec, X, X), beta,
                                            beta),
        "library_matmul": lambda: torch.matmul(X, Y.T),
    }
    out = {name: chip_smoke.time_ms(fn, iters=10)
           for name, fn in calls.items()}
    out["checksums"] = {name: checksum(calls[name]()) for name in (
        "gram_gaussian", "gram_linear", "sync_quadform")}
    return out


def e2e(fused) -> dict:
    from repro_torch.core import engine
    from repro_torch.data.streams import susy_stream

    out = {}
    for name, learner, m, pcfg, _ in chip_smoke.e2e_configs():
        if name not in E2E_RUNS:
            continue
        X, Y = susy_stream(chip_smoke.T_ROUNDS, m, d=chip_smoke.D_IN, seed=0)
        wrapper = WRAPPERS[name]
        inner = getattr(fused, wrapper)
        spent = [0.0, 0]

        def timed(*a, **k):
            t0 = time.perf_counter()
            res = inner(*a, **k)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return res

        setattr(fused, wrapper, timed)
        row = {"kernels_rounds_per_s": [], "reference_rounds_per_s": [],
               "wrapper_host_ms_per_call": []}
        try:
            for _ in range(2):
                for backend in ("kernels", "reference"):
                    spent[:] = [0.0, 0]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = engine.run(learner, pcfg, X, Y, backend=backend,
                                     device=DEVICE)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    row[f"{backend}_rounds_per_s"].append(
                        chip_smoke.T_ROUNDS / secs)
                    if backend == "kernels":
                        assert spent[1] > 0, f"{name}: {wrapper} never ran"
                        row["wrapper_host_ms_per_call"].append(
                            1e3 * spent[0] / spent[1])
                        row["num_syncs"] = int(res.num_syncs)
                        row["total_bytes"] = int(res.total_bytes)
        finally:
            setattr(fused, wrapper, inner)
        out[name] = row
    return out


def measure(path: Path) -> dict:
    """One visit: import ``repro_torch`` from ``path``/src and measure."""
    sys.path.insert(0, str(path / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build, fused
    assert Path(fused.__file__).resolve().is_relative_to(path), fused.__file__
    device_mod.resolve("cuda")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    return {"build_s": build_s, "kernels": kernel_times(fused, inputs(dev)),
            "sync": sync_times(dev), "e2e": e2e(fused)}


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="+", help="NAME=PATH")
    parser.add_argument("--order", help="comma-separated names, e.g. a,b,b,a")
    parser.add_argument("--visit", action="store_true",
                        help="measure the one tree given, in this process")
    args = parser.parse_args()
    trees = dict(t.split("=", 1) for t in args.trees)
    if args.visit:
        (name, path), = trees.items()
        print(json.dumps(measure((ROOT / path).resolve())), flush=True)
        return 0
    order = (args.order or "").split(",")
    unknown = set(order) - set(trees)
    if unknown:
        parser.error(f"--order names no tree: {sorted(unknown)}")
    out_dir = chip_smoke.OUT_DIR
    out_dir.mkdir(exist_ok=True)
    lines = [{"nvidia_smi": chip_smoke.nvidia_smi(),
              "device": torch.cuda.get_device_name(0)}]
    print(json.dumps(lines[0]), flush=True)
    for visit, name in enumerate(order):
        proc = subprocess.run(
            [sys.executable, __file__, f"{name}={trees[name]}", "--visit"],
            stdout=subprocess.PIPE, text=True, check=True)
        line = {"visit": visit, "tree": name,
                **json.loads(proc.stdout.strip().splitlines()[-1])}
        lines.append(line)
        print(json.dumps(line), flush=True)
    (out_dir / "kernel_ab.jsonl").write_text(
        "".join(json.dumps(line) + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
