"""Build and load the hand-written CUDA kernels, and launch them.

Route: ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together), links the objects into
one shared library with a plain C interface, and ``ctypes`` loads it.
No PyTorch headers are compiled, so a cold build takes seconds.

The library is built at first use into ``kernels/build/<hash>/``
(listed in .gitignore), keyed by a hash of the sources and the flags,
and renamed into place atomically so concurrent first uses cannot
load a half-written file.  A failed build raises with the compiler's
output; nothing falls back.

Every C entry point enqueues its kernel(s) on the stream it is given
and returns ``cudaGetLastError()``; ``launch`` raises on a non-zero
code and counts the launch in ``LAUNCH_COUNTS`` — the only place a
count is added, so a count says that the CUDA kernel really ran.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "librepro_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: expf / cosf keep their full-precision paths
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

#: Launches per kernel name, added to only where a CUDA kernel launches.
LAUNCH_COUNTS: collections.Counter = collections.Counter()

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of every entry point (all return a cudaError_t as int).
SIGNATURES = {
    # X, SV, A, out, B, N, d, kind, gamma, degree, coef0, cluster, chunk,
    # stream
    "repro_sv_predict": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _F, _I,
                         _I, _VP],
    # X, Y, alpha, beta, partial, out, P, M, N, d, kind, gamma, degree,
    # coef0, stream
    "repro_quadform": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F,
                       _I, _F, _VP],
    # X, y, w, b, W, bias, w_new, b_new, ell, yhat, B, d, D, featurize,
    # scale, loss, eta, decay, cluster, chunk, stream
    "repro_primal_step": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _I, _F, _I, _F, _F, _I, _I, _VP],
    # X, W, b, Z, M, D, d, scale, rows_per_thread, stream
    "repro_rff": [_VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP],
    # X, Y, K, M, N, d, kind, gamma, degree, coef0, stream
    "repro_gram": [_VP, _VP, _VP, _I, _I, _I, _I, _F, _I, _F, _VP],
    # q, k, v, o, BH, S, L, hd, bf16, scale, causal, window, stream
    "repro_flash": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _I, _I,
                    _VP],
}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}

#: Listeners told of every piece of compiled work that was not cached:
#: ``listener(what, seconds)``.  Each active
#: ``telemetry.probe.CompileCounter`` is one.
COMPILE_LISTENERS: list = []


def note_compile(what: str, seconds: float = 0.0) -> None:
    """Report compiled work that missed its cache (an nvcc build, a
    library load, a new launch geometry)."""
    for listener in COMPILE_LISTENERS:
        listener(what, seconds)


def compiled_cache(fn):
    """``functools.lru_cache`` for a launch geometry that reports each
    miss through ``note_compile``."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def lookup(*args):
        misses = cached.cache_info().misses
        t0 = time.perf_counter()
        out = cached(*args)
        if cached.cache_info().misses != misses:
            note_compile(fn.__name__, time.perf_counter() - t0)
        return out

    lookup.cache_info = cached.cache_info
    lookup.cache_clear = cached.cache_clear
    return lookup


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels (PATH, CUDA_HOME or /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists() and not force:
        BUILD_INFO.update(path=str(lib), cached=True, seconds=0.0)
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        (out_dir / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    seconds = time.perf_counter() - t0
    BUILD_INFO.update(path=str(lib), cached=False, seconds=seconds, log=log)
    note_compile("nvcc", seconds)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        path = build()
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        note_compile("load", time.perf_counter() - t0)
    return _LIB


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(count_as: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``; raise on a CUDA error
    code, then count one launch of ``count_as``."""
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")
    LAUNCH_COUNTS[count_as] += 1


def check_operands(name: str, device: torch.device,
                   dtypes: tuple = (torch.float32,), **tensors) -> None:
    """Refuse what the kernels do not take: every operand on ``device``,
    of a dtype the kernel declares in ``dtypes`` (float32 unless it says
    otherwise) and contiguous."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {key} is {t.dtype}; the kernel "
                             f"takes {', '.join(map(str, dtypes))}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
