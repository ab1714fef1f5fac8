"""Roofline analysis over the dry-run records (port of
``repro/launch/roofline.py``), with one H100's constants
(``launch/mesh.py``).

Per (arch x shape x mesh) record of ``launch/dryrun.py``:

  compute term    = flops_per_device / PEAK_FLOPS_BF16              [s]
  memory term     = bytes_per_device / HBM_BW                       [s]
  collective term = collective_bytes_per_device * f / LINK_BW       [s]

An all-reduce of X bytes moves about 2X over a ring (reduce-scatter
plus all-gather), every other collective about X: the factor f is
applied per kind.  The port's own records carry no collective bytes
(``collective_bytes`` is ``{}``: one process has no partitioner), so
their collective term is 0 and the dominant term is compute or memory;
a record in the reference's format, collective bytes included, is read
unchanged.

MODEL_FLOPS uses the 6 N D convention (2 N D for an inference forward;
N = the active non-embedding parameters for MoE); the ratio
MODEL_FLOPS / (flops x devices) exposes recompute and redundancy.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from ..models.config import param_count
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from .specs import SHAPES

_COLL_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather round trip
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def active_params(cfg) -> int:
    """Non-embedding (active, for MoE) parameter count for 6ND."""
    total = param_count(cfg)
    emb = cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    body = total - emb
    if cfg.n_experts:
        # scale expert tensors by top_k / n_experts
        expert = len([k for k in cfg.pattern if k == "moe"]) * \
            cfg.n_experts * 3 * cfg.d_model * cfg.expert_ff
        body = body - expert + expert * cfg.top_k / cfg.n_experts
    return int(body)


def model_flops(cfg, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    n = active_params(cfg)
    if sh["kind"] == "train":
        tokens = sh["batch"] * sh["seq"]
        return 6.0 * n * tokens
    if sh["kind"] == "prefill":
        tokens = sh["batch"] * sh["seq"]
        return 2.0 * n * tokens
    tokens = sh["batch"] * 1
    return 2.0 * n * tokens


def analyze_record(rec: Dict) -> Dict:
    from ..configs import get
    from .specs import variant_for
    cfg = variant_for(get(rec["arch"]), rec["shape"])

    devices = rec["devices"]
    compute_s = (rec["flops"] or 0.0) / PEAK_FLOPS_BF16
    memory_s = (rec["bytes_accessed"] or 0.0) / HBM_BW
    # reprolint: allow[ACC01] roofline seconds model: bytes scale into time terms, not the ledger
    coll_bytes = sum(
        _COLL_FACTOR.get(k, 1.0) * v
        for k, v in (rec.get("collective_bytes") or {}).items())
    # reprolint: allow[ACC01] roofline seconds model: bytes scale into time terms, not the ledger
    collective_s = coll_bytes / LINK_BW

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, rec["shape"])
    flops_global = (rec["flops"] or 0.0) * devices
    ratio = mf / flops_global if flops_global else float("nan")

    bound_s = max(terms.values())
    mfu_bound = (mf / devices / PEAK_FLOPS_BF16) / bound_s if bound_s else 0.0

    return {
        **rec,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": ratio,
        "mfu_upper_bound": mfu_bound,
        "suggestion": _suggest(rec, cfg, dominant, ratio),
    }


def _suggest(rec, cfg, dominant, ratio) -> str:
    if dominant == "collective":
        kinds = rec.get("collective_bytes") or {}
        top = max(kinds, key=kinds.get) if kinds else "?"
        return (f"dominated by {top}: overlap it with compute or reshard to "
                f"remove the largest resharding (likely the logits/vocab or "
                f"expert all-to-all path)")
    if dominant == "memory":
        return ("HBM-bound: fuse/keep activations in bf16, increase "
                "arithmetic intensity (bigger per-device batch), or shard "
                "the largest resident tensor (KV cache / logits)")
    if ratio is not None and ratio < 0.5:
        return ("compute-bound but <50% useful flops: remove recompute/"
                "redundant ops (remat policy, duplicate projections, "
                "dense-MoE decode)")
    return "compute-bound near useful-flops roofline: good placement"


def load_records(outdir: str = "experiments/dryrun") -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(outdir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def markdown_table(analyzed: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful ratio | MFU bound |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    if any(not a.get("collective_bytes") for a in analyzed):
        hdr = ("A record without collective bytes (the port's: one process "
               "has no partitioner) has a collective term of 0; its "
               "dominant term is compute or memory.\n\n" + hdr)
    rows = []
    for a in analyzed:
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['compute_s']:.3e} | {a['memory_s']:.3e} "
            f"| {a['collective_s']:.3e} | **{a['dominant']}** "
            f"| {a['useful_ratio']:.2f} | {a['mfu_upper_bound']*100:.0f}% |")
    return hdr + "\n".join(rows) + "\n"


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="experiments/dryrun")
    ap.add_argument("--json-out", default="experiments/roofline.json")
    args = ap.parse_args(argv)
    recs = [analyze_record(r) for r in load_records(args.outdir)]
    recs.sort(key=lambda r: (r["shape"], r["arch"], r["mesh"]))
    print(markdown_table(recs))
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(recs, f, indent=2)
    for r in recs:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:6s} -> "
              f"{r['dominant']:10s} | {r['suggestion']}")


if __name__ == "__main__":
    main()
