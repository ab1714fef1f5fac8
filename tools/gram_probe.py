"""Probe the ``gram`` kernel of trees of the port, on one card.

    python3 tools/gram_probe.py PATH [PATH ...]

Each PATH is a directory holding ``src/repro_torch`` (``.`` for this
checkout, or a tree unpacked into a directory .gitignore lists, as
``tools/kernel_ab.py`` takes them).  For each PATH, in that order and
each in a fresh process (one kernel library a process), it prints one
JSON line:

- ``max_err``: the largest |gram - plain| (``ref.gram_ref``) at M = 130,
  N = 4097 for d in ``CHECK_D`` and both of gram's main kinds, and
  ``bad``, the elements outside rtol = atol = 2e-5: a probe of a
  feature loop's remainder at every d;
- the device ms (``chip_smoke.time_ms``) of ``gram`` at the SV sync's
  shape, M = N = 32768, linear and gaussian, at d = 0 (the kernel's
  store pattern alone: no feature is staged or summed), 1, 4 and 18,
  beside ``fill_`` of a buffer of that size (a PyTorch call, timed
  only: what a pure store stream of 4.29 GB takes).

It stops at the first call that faults and prints the fault.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

CHECK_D = (1, 2, 3, 4, 5, 7, 8, 16, 17, 19, 20, 34, 35)
TIME_D = (0, 1, 4, 18)
KINDS = ("linear", "gaussian")


def visit(path: Path) -> dict:
    sys.path.insert(0, str(path / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import gram, ref
    assert Path(gram.__file__).resolve().is_relative_to(path), gram.__file__
    dev = device_mod.resolve("cuda")
    gen = torch.Generator().manual_seed(1)
    out = {"tree": str(path), "max_err": {}, "bad": {}}
    try:
        for d in CHECK_D:
            for kind in KINDS:
                X = torch.randn(130, d, generator=gen).to(dev)
                Y = torch.randn(4097, d, generator=gen).to(dev)
                K = gram.gram(X, Y, kind=kind, gamma=chip_smoke.GAMMA)
                want = ref.gram_ref(X, Y, kind=kind, gamma=chip_smoke.GAMMA)
                err = (K - want).abs()
                out["max_err"][f"{kind}_d{d}"] = float(err.max())
                out["bad"][f"{kind}_d{d}"] = int(
                    (err > 2e-5 + 2e-5 * want.abs()).sum())
        M = chip_smoke.GRAM_M
        X = torch.randn(M, max(TIME_D), generator=gen).to(dev)
        Y = torch.randn(M, max(TIME_D), generator=gen).to(dev)
        for d in TIME_D:
            Xd, Yd = X[:, :d].contiguous(), Y[:, :d].contiguous()
            for kind in KINDS:
                out[f"{kind}_d{d}_device_ms"] = chip_smoke.time_ms(
                    lambda: gram.gram(Xd, Yd, kind=kind,
                                      gamma=chip_smoke.GAMMA),
                    iters=10)["device_ms"]
        buf = torch.empty(M, M, device=dev)
        out["fill_device_ms"] = chip_smoke.time_ms(
            lambda: buf.fill_(1.0), iters=10)["device_ms"]
    except RuntimeError as e:
        out["fault"] = repr(e)[:300]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gram_probe: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--visit"]:
        print(json.dumps(visit((ROOT / sys.argv[2]).resolve())), flush=True)
        return 0
    print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    for path in sys.argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--visit", path],
                              stdout=subprocess.PIPE, text=True, check=True)
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
