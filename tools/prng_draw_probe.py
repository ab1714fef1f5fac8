"""Seconds and peak memory of the port's seeded normal draw on the card.

    python3 tools/prng_draw_probe.py [--other SRC] [--sizes N ...]

Times ``repro_torch.prng.normal`` at each size (elements; the default
runs 2^20, 2^22, 2^26 and ``qwen3_14b``'s embedding, 151,936 x 5,120)
from one key, on the card.  With ``--other SRC`` it also times the
``prng`` of another source tree (``SRC/repro_torch/prng.py`` and the
modules it imports from its package, loaded beside this tree's), in
turns other, this, this, other, and checks that both draws are the same
bits.  Prints a JSON line a size, the card's name and power limit first,
and writes the lines to ``chiprun_out/prng_draw_probe.json``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import prng  # noqa: E402

SIZES = (1 << 20, 1 << 22, 1 << 26, 151_936 * 5_120)


def load_other(src: str):
    """``SRC/repro_torch/prng.py`` as the module ``other_repro_torch.prng``
    (its package's ``__init__`` not run)."""
    pkg = types.ModuleType("other_repro_torch")
    pkg.__path__ = [str(Path(src).resolve() / "repro_torch")]
    sys.modules["other_repro_torch"] = pkg
    return importlib.import_module("other_repro_torch.prng")


def timed(fn):
    """(fn(), its seconds, the device bytes it took at its peak beyond
    what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - before)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another tree's src directory")
    ap.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prng_draw_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(),
        flush=True)
    dev = torch.device("cuda")
    draws = {"this": prng}
    if args.other:
        draws["other"] = load_other(args.other)
    order = ["other", "this", "this", "other"] if args.other else ["this"] * 2
    key = prng.fold_in(prng.split(prng.PRNGKey(0))[1], 7)
    rows = []
    for n in args.sizes:
        for mod in draws.values():
            mod.normal(key, (1 << 16,), device=dev)      # warm
        row = {"elements": n}
        first = {}
        for name in order:
            out, secs, peak = timed(
                lambda: draws[name].normal(key, (n,), device=dev))
            row.setdefault(f"{name}_s", []).append(secs)
            row[f"{name}_ns_per_element"] = min(row[f"{name}_s"]) / n * 1e9
            row[f"{name}_peak_bytes"] = peak
            first.setdefault(name, out)
            del out
        if args.other:
            row["same_bits"] = torch.equal(first["this"].view(torch.int32),
                                           first["other"].view(torch.int32))
        del first
        rows.append(row)
        print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "prng_draw_probe.json").write_text(json.dumps(rows, indent=1))
    return 0 if all(r.get("same_bits", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
