"""Flash attention: the wrapper of ``csrc/flash.cu``.

O = softmax(scale q k^T, masked) v for folded heads, the online-softmax
recurrence in float32 and the output in the input dtype.  Replaces
``repro/kernels/flash.py::flash_attention``; the LM's prefill reaches it
through ``models/attention.py::_flash_sdpa`` once per layer.

Unlike the TPU kernel, it takes any S and L: the kernel masks the
ragged edge itself, so no caller pads.  Queries and keys are aligned at
position 0 (query i may see key j <= i when causal), as there.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and counts
the launch (``_build.LAUNCH_COUNTS["flash"]``).  A CPU tensor goes to
the plain version (``ref.flash_ref``); a CUDA tensor goes to the
kernel, or the wrapper raises.
"""
from __future__ import annotations

import torch

from . import _build, ref

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (64, 128)
#: Input (and output) dtypes the kernel takes.
DTYPES = (torch.float32, torch.bfloat16)
#: Where the kernel's products run.
ROUTE = "float32 FMA on the CUDA cores"


def flash_attention(q, k, v, *, scale=None, causal=True,
                    window=0) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH, L, hd) -> (BH, S, hd) in q's dtype.
    ``scale`` defaults to hd ** -0.5; ``window > 0`` also hides keys
    j <= i - window from query i."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    BH, S, hd = q.shape
    L = k.shape[1]
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_ref(q, k, v, scale=scale, causal=causal,
                             window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash: unsupported device {q.device}")
    _build.check_operands("flash", q.device, dtypes=DTYPES, q=q, k=k, v=v)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash: head dim {hd} is not one of {HEAD_DIMS}")
    if BH > 65535:
        raise ValueError(f"flash: {BH} heads exceed the grid's y extent")
    o = torch.empty_like(q)
    if BH == 0 or S == 0:
        return o
    _build.launch(
        "flash", "repro_flash", q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        BH, S, L, hd, int(q.dtype == torch.bfloat16), scale, int(causal),
        int(window), _build.stream_of(q))
    return o
