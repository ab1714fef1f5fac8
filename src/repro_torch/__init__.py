"""PyTorch/CUDA port of the distributed online kernel-learning system.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core.rkhs``, ``core.engine``, ``kernels.ops``, ...) so
each counterpart is easy to find, and is held against it on the same
inputs (tests/test_torch_*.py).  It imports torch and numpy only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve``); on the CPU every hand-written
kernel is replaced by its plain PyTorch version (``kernels/ref.py``).
"""
from .device import resolve as resolve_device

__all__ = ["resolve_device"]
