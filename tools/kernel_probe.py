"""Probe one kernel of trees of the port, on one card.

    python3 tools/kernel_probe.py KERNEL PATH [PATH ...]

KERNEL is ``gram`` or ``rff``.  Each PATH is a directory holding
``src/repro_torch`` (``.`` for this checkout, or a tree unpacked into a
directory .gitignore lists, as ``tools/kernel_ab.py`` takes them).  For
each PATH, in that order and each in a fresh process (one kernel
library a process), it prints one JSON line.

``gram``:

- ``max_err``: the largest |gram - plain| (``ref.gram_ref``) at M = 130,
  N = 4097 for d in ``GRAM_CHECK_D`` and both of gram's main kinds, and
  ``bad``, the elements outside rtol = atol = 2e-5: a probe of a
  feature loop's remainder at every d;
- the device ms (``chip_smoke.time_ms``) of ``gram`` at the SV sync's
  shape, M = N = 32768, linear and gaussian, at d = 0 (the kernel's
  store pattern alone: no feature is staged or summed), 1, 4 and 18,
  beside ``fill_`` of a buffer of that size (a PyTorch call, timed
  only: what a pure store stream of 4.29 GB takes).

``rff``:

- ``max_err`` / ``bad``: the largest |rff - plain| (``ref.rff_ref``) and
  the elements beyond ``chip_smoke.rff_atol`` at D = 2048 for every
  bucket size M of ``chip_smoke.RFF_BUCKETS`` and d in ``RFF_CHECK_D``,
  with X as given and copied to start 4 bytes past a 16-byte boundary
  (``_off16``); ``rows_differ``: the bucket sizes at which a row
  differs from the one-row call (bitwise);
- ``device_ms``: the device ms of ``rff`` at D = 2048 for every bucket
  size and d of ``RFF_TIME_D``: a time that follows d says the feature
  loop's loads set it, one that follows neither M nor d says the grid
  and the launch do; beside them the launch floor (``add_`` on one
  element);
- ``sass``: per ``rff_kernel`` function of the built library, the count
  of each floating-point opcode (FFMA, FMUL, FADD, MUFU) in its SASS
  (``cuobjdump -sass``): FFMA and no FMUL / FADD pair in the feature
  loop says the sum is contracted to FMAs.

It stops at the first call that faults and prints the fault.
"""
from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

GRAM_CHECK_D = (1, 2, 3, 4, 5, 7, 8, 16, 17, 19, 20, 34, 35)
GRAM_TIME_D = (0, 1, 4, 18)
GRAM_KINDS = ("linear", "gaussian")
RFF_CHECK_D = (1, 4, 7, 18, 33)
RFF_TIME_D = (1, 4, 18)
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU")


def probe_gram(kernels, dev, gen, out: dict) -> None:
    gram, ref = kernels.gram, kernels.ref
    out.update(max_err={}, bad={})
    for d in GRAM_CHECK_D:
        for kind in GRAM_KINDS:
            X = torch.randn(130, d, generator=gen).to(dev)
            Y = torch.randn(4097, d, generator=gen).to(dev)
            K = gram.gram(X, Y, kind=kind, gamma=chip_smoke.GAMMA)
            want = ref.gram_ref(X, Y, kind=kind, gamma=chip_smoke.GAMMA)
            err = (K - want).abs()
            out["max_err"][f"{kind}_d{d}"] = float(err.max())
            out["bad"][f"{kind}_d{d}"] = int(
                (err > 2e-5 + 2e-5 * want.abs()).sum())
    M = chip_smoke.GRAM_M
    X = torch.randn(M, max(GRAM_TIME_D), generator=gen).to(dev)
    Y = torch.randn(M, max(GRAM_TIME_D), generator=gen).to(dev)
    for d in GRAM_TIME_D:
        Xd, Yd = X[:, :d].contiguous(), Y[:, :d].contiguous()
        for kind in GRAM_KINDS:
            out[f"{kind}_d{d}_device_ms"] = chip_smoke.time_ms(
                lambda: gram.gram(Xd, Yd, kind=kind, gamma=chip_smoke.GAMMA),
                iters=10)["device_ms"]
    buf = torch.empty(M, M, device=dev)
    out["fill_device_ms"] = chip_smoke.time_ms(
        lambda: buf.fill_(1.0), iters=10)["device_ms"]


def sass_counts(lib: Path, nvcc: str) -> dict:
    """Opcode counts of every function whose name holds rff_kernel."""
    tool = Path(nvcc).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "rff_kernel" in m.group(1) else None
            if name:
                out[name] = collections.Counter()
        elif name:
            op = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
            if op and op.group(1) in OPCODES:
                out[name][op.group(1)] += 1
    return {k: dict(v) for k, v in out.items()}


def probe_rff(kernels, dev, gen, out: dict) -> None:
    rff, ref = kernels.rff, kernels.ref
    buckets = chip_smoke.RFF_BUCKETS
    D = chip_smoke.N_FEATURES
    atol = chip_smoke.rff_atol(D)
    out.update(max_err={}, bad={}, rows_differ={}, device_ms={})

    def operands(d):
        return (torch.randn(max(buckets), d, generator=gen).to(dev),
                (0.3 * torch.randn(D, d, generator=gen)).to(dev),
                (6.0 * torch.rand(D, generator=gen)).to(dev))

    for d in RFF_CHECK_D:
        X, W, b = operands(d)
        for M in buckets:
            for tag, x in (("", X[:M]), ("_off16", chip_smoke.off16(X[:M]))):
                Z = rff.rff(x, W, b)
                err = (Z - ref.rff_ref(x, W, b)).abs()
                out["max_err"][f"M{M}_d{d}{tag}"] = float(err.max())
                out["bad"][f"M{M}_d{d}{tag}"] = int((err > atol).sum())
            rows = [i for i in range(M) if not torch.equal(
                rff.rff(X[i:i + 1], W, b)[0], Z[i])]
            if rows:
                out["rows_differ"][f"M{M}_d{d}"] = rows
    for d in RFF_TIME_D:
        X, W, b = operands(d)
        for M in buckets:
            x = X[:M]
            out["device_ms"][f"M{M}_d{d}"] = chip_smoke.time_ms(
                lambda: rff.rff(x, W, b))["device_ms"]
    one = torch.zeros(1, device=dev)
    out["launch_floor_device_ms"] = chip_smoke.time_ms(
        lambda: one.add_(1.0))["device_ms"]
    out["sass"] = sass_counts(kernels._build.build(),
                              kernels._build._nvcc())


PROBES = {"gram": probe_gram, "rff": probe_rff}


def visit(kernel: str, path: Path) -> dict:
    sys.path.insert(0, str(path / "src"))
    from repro_torch import device as device_mod
    from repro_torch import kernels
    from repro_torch.kernels import _build, gram, ref, rff  # noqa: F401
    assert Path(kernels.__file__).resolve().is_relative_to(path), \
        kernels.__file__
    dev = device_mod.resolve("cuda")
    out = {"tree": str(path), "kernel": kernel}
    try:
        PROBES[kernel](kernels, dev, torch.Generator().manual_seed(1), out)
    except RuntimeError as e:
        out["fault"] = repr(e)[:300]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--visit"]:
        print(json.dumps(visit(sys.argv[2], (ROOT / sys.argv[3]).resolve())),
              flush=True)
        return 0
    if len(sys.argv) < 3 or sys.argv[1] not in PROBES:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    kernel = sys.argv[1]
    print(json.dumps({"nvidia_smi": chip_smoke.nvidia_smi()}), flush=True)
    for path in sys.argv[2:]:
        proc = subprocess.run(
            [sys.executable, __file__, "--visit", kernel, path],
            stdout=subprocess.PIPE, text=True, check=True)
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
