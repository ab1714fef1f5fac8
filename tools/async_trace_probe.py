"""The first substrate call whose output differs between the card and
the CPU in one async run.

    python3 tools/async_trace_probe.py [--exact-node] [DEVICE DEVICE]

``tools/async_bytes_probe.py``'s run (``examples/async_susy.py``'s "WAN,
poly staleness": 4 SV learners, budget 64, 200 rounds) on each device
(default: the card, then the CPU), every call of the SV node face and
the coordinator (``update_one``, ``predict_one``, ``dist_one``,
``upload_payload``, ``aggregate``) recorded with a hash of its output.
Prints both runs' total bytes, the first call whose output differs, the
count of differing calls by kind, and the first call whose inputs are
equal on both devices and whose output is not (the operation that
parts them), with its inputs written to
``chiprun_out/async_trace_first.pkl``.

``--exact-node`` runs the SV node face (``update_one``, ``predict_one``,
``dist_one``) on expressions whose floats do not depend on the device:
every sum over the last axis left to right, one element at a time, and
``exp`` taken in float64 and rounded once (PyTorch's CUDA reductions
and ``expf`` round otherwise than its CPU ones).  The substrate's other
calls are the port's own, so a call that still parts the devices there
is outside the node face.
"""
from __future__ import annotations

import hashlib
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import learners, rkhs, substrate  # noqa: E402
from repro_torch.core.learners import LearnerConfig  # noqa: E402
from repro_torch.core.rkhs import KernelSpec  # noqa: E402
from repro_torch.data import susy_stream  # noqa: E402
from repro_torch.runtime import (AsyncProtocolConfig, SystemConfig,  # noqa: E402
                                 run_async_simulation)

T, M, D = 200, 4, 8
OUT = ROOT / "chiprun_out"


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _hash(*ts) -> str:
    h = hashlib.sha1()
    for t in ts:
        h.update(np.ascontiguousarray(_np(t)).tobytes())
    return h.hexdigest()[:16]


def _model(f):
    return [_np(f.sv), _np(f.alpha), _np(f.sv_id)]


def _seq_sum(v: torch.Tensor) -> torch.Tensor:
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
        s = s + v[..., i]
    return s


def _rows(spec, X, Y):
    """The gaussian Gram rows with ``_seq_sum`` and a float64 ``exp``."""
    cross = _seq_sum(X[..., :, None, :] * Y[..., None, :, :])
    xx = _seq_sum(X * X)[..., :, None]
    yy = _seq_sum(Y * Y)[..., None, :]
    sq = torch.clamp(xx + yy - 2.0 * cross, min=0.0)
    return torch.exp((-spec.gamma * sq).double()).float()


def _exact_node_face() -> None:
    S = substrate.SVSubstrate

    def predict(spec, f, x):
        return _seq_sum(_rows(spec, x[None], f.sv)
                        * rkhs.masked_alpha(f)[None, :])[0]

    def form(K, a, b):
        return _seq_sum(a * _seq_sum(K * b[None, :]))

    def update_one(sub, state, example):
        yhat = predict(sub.lcfg.kernel, state.model, example[0])
        return learners.kernel_update_from_yhat(sub.lcfg, state, example,
                                                yhat)

    def dist_one(sub, f, g):
        spec = sub.lcfg.kernel
        af, ag = rkhs.masked_alpha(f), rkhs.masked_alpha(g)
        return (form(_rows(spec, f.sv, f.sv), af, af)
                + form(_rows(spec, g.sv, g.sv), ag, ag)
                - 2.0 * form(_rows(spec, f.sv, g.sv), af, ag))

    S.update_one = update_one
    S.dist_one = dist_one
    S.predict_one = lambda sub, f, x: predict(sub.lcfg.kernel, f, x)


class _Trace:
    """Wraps the SV substrate's calls; ``calls[device]`` in call order."""

    def __init__(self):
        self.calls: dict = {}
        self.device = None
        S = substrate.SVSubstrate
        self.orig = {k: getattr(S, k) for k in (
            "update_one", "predict_one", "dist_one", "upload_payload",
            "aggregate")}
        trace = self

        def update_one(sub, state, example):
            new, loss = trace.orig["update_one"](sub, state, example)
            trace.add("update", {"model": _model(state.model),
                                 "counter": _np(state.counter),
                                 "x": _np(example[0]), "y": _np(example[1])},
                      _hash(*_model(new.model), loss))
            return new, loss

        def predict_one(sub, model, x):
            y = trace.orig["predict_one"](sub, model, x)
            trace.add("predict", {"model": _model(model), "x": _np(x)},
                      _hash(y))
            return y

        def dist_one(sub, model, ref):
            d = trace.orig["dist_one"](sub, model, ref)
            trace.add("dist", {"model": _model(model), "ref": _model(ref)},
                      _hash(d))
            return d

        def upload_payload(sub, bm, state, known):
            out = trace.orig["upload_payload"](sub, bm, state, known)
            trace.add("upload", {"model": _model(state.model),
                                 "known": sorted(known)}, str(out[2]))
            return out

        def aggregate(sub, reference, models, weights):
            out = trace.orig["aggregate"](sub, reference, models, weights)
            trace.add("aggregate", {"ref": _model(reference),
                                    "models": [_model(f) for f in models],
                                    "weights": [float(w) for w in weights]},
                      _hash(*_model(out[0])))
            return out

        for k, f in (("update_one", update_one), ("predict_one", predict_one),
                     ("dist_one", dist_one),
                     ("upload_payload", upload_payload),
                     ("aggregate", aggregate)):
            setattr(S, k, f)

    def add(self, kind, inputs, out):
        self.calls[self.device].append((kind, pickle.dumps(inputs), out))


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    if "--exact-node" in args:
        args.remove("--exact-node")
        _exact_node_face()
    devices = args or ["cuda", "cpu"]
    X, Y = susy_stream(T=T, m=M, d=D, seed=0)
    lcfg = LearnerConfig(algo="kernel_sgd", loss="hinge", eta=0.5, lam=0.01,
                         budget=64, kernel=KernelSpec("gaussian", gamma=0.3),
                         dim=D)
    acfg = AsyncProtocolConfig(kind="dynamic", delta=2.0, alpha=0.6,
                               staleness="poly", stale_a=0.5, agg_window=1.0)
    sys_cfg = SystemConfig(seed=0, compute_jitter=0.3, straggler_frac=0.25,
                           straggler_mult=4.0, straggler_prob=0.3,
                           base_latency=0.5, latency_jitter=0.5,
                           bandwidth=1e5)
    trace = _Trace()
    for i, dev in enumerate(devices):
        trace.device = (i, dev)
        trace.calls[trace.device] = []
        res = run_async_simulation(lcfg, acfg, X, Y, sys_cfg=sys_cfg,
                                   record_divergence=False, device=dev)
        print(f"{dev}: total_bytes {int(res.total_bytes)}, "
              f"{len(trace.calls[trace.device])} calls")
    a, b = (trace.calls[k] for k in list(trace.calls)[:2])
    differ = [i for i, (x, y) in enumerate(zip(a, b))
              if x[0] != y[0] or x[2] != y[2]]
    kinds: dict = {}
    for i in differ:
        kinds[a[i][0]] = kinds.get(a[i][0], 0) + 1
    print("first call that differs:",
          f"{differ[0]} ({a[differ[0]][0]})" if differ else None)
    print("differing calls by kind:", kinds)
    parting = next((i for i in differ if a[i][1] == b[i][1]), None)
    if parting is None:
        print("no call parts the devices on equal inputs")
        return 0
    print(f"parting call: {parting} ({a[parting][0]}), "
          f"output {a[parting][2]} against {b[parting][2]}")
    OUT.mkdir(exist_ok=True)
    with open(OUT / "async_trace_first.pkl", "wb") as fh:
        pickle.dump({"index": parting, "kind": a[parting][0],
                     "inputs": pickle.loads(a[parting][1]),
                     "outputs": (a[parting][2], b[parting][2]),
                     "devices": devices}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
