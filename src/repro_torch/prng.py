"""The reference's seeded draws: JAX's threefry-2x32 in plain torch ops.

The counterpart of what the reference takes from ``jax.random``, with
``jax_threefry_partitionable`` on (JAX's default):

    key = PRNGKey(seed)               # (2,) words
    k1, k2 = split(key)               # (n, 2) words, ``foldlike``
    k = fold_in(key, data)
    random_bits(key, shape)           # bits1 ^ bits2 of each flat index
    uniform(key, shape, minval, maxval)
    normal(key, shape)

A key is an int64 tensor of shape (2,) on the CPU holding two uint32
words; ``split`` gives an (n, 2) tensor whose rows are keys.  The draws
run on an explicit ``device``: uint32 arithmetic on int32 bits (adds
wrap; a logical shift is an arithmetic one masked), and float32 math
from ``xla_math`` (XLA's CPU ``erf_inv`` over its ``log1p``, products
fused where XLA fuses them).
An element's bits depend only on the key and its flat index, so a draw
is the same on the CPU and on the card, and ``*_at`` draws any range of
flat indices alone.  Large draws run in chunks (``CHUNK`` elements on
the CPU, ``CUDA_CHUNK`` on the card).
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from . import xla_math

Key = torch.Tensor
Shape = Union[int, Sequence[int]]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: elements a draw computes at once on the CPU: few enough that an
#: elementwise pass's float64 temporaries stay in cache
CHUNK = 1 << 16
#: on the card: each pass long enough to hide the host's launches
CUDA_CHUNK = 1 << 26


def _i32(v: int) -> int:
    """A uint32 value as the int32 with its bits."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def _threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of the count pairs (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection every four.  x1 and x2 are
    int32 tensors holding uint32 bits (adds wrap, a logical right shift
    is an arithmetic one masked); they are overwritten."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1.add_(_i32(ks[0]))
    x2.add_(_i32(ks[1]))
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2)
            # x2 = rotl(x2, r) ^ x1
            hi = (x2 >> (32 - r)).bitwise_and_((1 << r) - 1)
            x2.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_xor_(x1)
        x1.add_(_i32(ks[(i + 1) % 3]))
        x2.add_(_i32(ks[(i + 2) % 3] + i + 1))
    return x1, x2


def _counts(index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of int64 flat indices, as int32 bits."""
    return (index >> 32).to(torch.int32), \
        (index & _M32).to(torch.int32)


def _u32(v: torch.Tensor) -> torch.Tensor:
    """int32 bits as their uint32 values, in int64."""
    return v.to(torch.int64) & _M32


def _words(key: Key) -> Tuple[int, int]:
    k1, k2 = (int(v) for v in key.tolist())
    return k1, k2


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with JAX's 64-bit types off (the
    reference's setting): the words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _bits_flat(key: Key, index: torch.Tensor) -> torch.Tensor:
    """The partitionable random bits at the int64 flat indices, as int32
    bits."""
    k1, k2 = _words(key)
    b1, b2 = _threefry2x32(k1, k2, *_counts(index))
    return b1.bitwise_xor_(b2)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)``: (num, 2) keys, the hash of the
    64-bit iota (the ``foldlike`` split)."""
    k1, k2 = _words(key)
    b1, b2 = _threefry2x32(k1, k2, *_counts(torch.arange(num)))
    return torch.stack([_u32(b1), _u32(b2)], dim=1)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    (0, data)."""
    k1, k2 = _words(key)
    b1, b2 = _threefry2x32(k1, k2, torch.zeros(1, dtype=torch.int32),
                           torch.tensor([_i32(int(data))], dtype=torch.int32))
    return torch.cat([_u32(b1), _u32(b2)])


def bits_at(key: Key, index: torch.Tensor) -> torch.Tensor:
    """``random_bits`` at the given int64 flat indices (on the device to
    draw on): uint32 values in int64."""
    with _serial(index.device):
        return _u32(_bits_flat(key, index))


def _uniform_flat(key: Key, index: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    # the mantissa trick: 23 random bits under the exponent of 1.0
    bits = _bits_flat(key, index)
    bits = (bits >> 9).bitwise_and_(0x7FFFFF).bitwise_or_(0x3F800000)
    floats = bits.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(lo)))
    return torch.clamp_min(xla_math.fma(floats, span, lo), lo)


@contextlib.contextmanager
def _serial(device: torch.device):
    """A CPU draw on one intra-op thread: it is some 300 short
    elementwise ops, whose parallel regions cost more than they save,
    and far more when processes share the cores."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def uniform_at(key: Key, index: torch.Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """``uniform`` at the given int64 flat indices."""
    with _serial(index.device):
        return _uniform_flat(key, index, minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal_at(key: Key, index: torch.Tensor) -> torch.Tensor:
    """``normal`` at the given int64 flat indices."""
    with _serial(index.device):
        u = _uniform_flat(key, index, _NORMAL_LO, 1.0)
        return _SQRT2 * xla_math.erf_inv(u)


def _draw(fn, key: Key, shape: Shape, device) -> torch.Tensor:
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    chunk = CHUNK if out.device.type == "cpu" else CUDA_CHUNK
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        out[start:stop] = fn(key, torch.arange(start, stop, dtype=torch.int64,
                                               device=out.device))
    return out.reshape(shape)


def random_bits(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): uint32 values in int64."""
    shape = _shape(shape)
    n = math.prod(shape)
    return bits_at(key, torch.arange(n, dtype=torch.int64,
                                     device=device)).reshape(shape)


def uniform(key: Key, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32."""
    return _draw(lambda k, i: uniform_at(k, i, minval, maxval), key, shape,
                 device)


def normal(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32."""
    return _draw(normal_at, key, shape, device)
