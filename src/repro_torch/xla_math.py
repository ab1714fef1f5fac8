"""XLA's CPU float32 elementwise math in plain torch ops.

The reference's random draws and ``A_log`` go through XLA's CPU
``log``, ``log1p`` and ``erf_inv``.  Their float32 bits are not
PyTorch's (``torch.log``, ``torch.log1p`` and ``torch.special.erfinv``
round differently), so the port reproduces the computations XLA's CPU
backend compiles: the same polynomials in the same order, with each
product that LLVM contracts into the sum that takes it (``fma``: one
rounding).  Every function here is a fixed sequence of elementwise
torch ops, none of them fused or contracted, so it gives the same bits
on the CPU and on the card.

``fma`` rounds once: the product of two float32 values is exact in
float64, and the float64 sum rounded to odd, then to float32, is the
exact sum's rounding.  Where a product is exact in float32 (a power of
two, or few enough bits), the fused sum is a float32 add.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_F64 = torch.float64


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32.  a, b and c are float32 or
    float64 tensors holding float32 values, or Python floats (taken as
    float32; kept as scalars, so no constant is copied to the device),
    a or b a tensor.  The product is exact in float64 (where PyTorch's
    type promotion makes it float64, a float32 operand is converted as
    it is read; else the float32 tensors are converted first).  The
    float64 sum is rounded to odd, then to float32, which rounds as the
    exact sum would (round-to-odd needs two more bits than float32's
    mantissa; float64 has 29)."""
    a, b, c = (v if torch.is_tensor(v) else float(np.float32(v))
               for v in (a, b, c))
    if torch.result_type(a, b) != _F64:
        a, b = (v.to(_F64) if torch.is_tensor(v) else v for v in (a, b))
    p = a * b
    if torch.result_type(p, c) != _F64:
        c = c.to(_F64)
    s = p + c
    # the sum's rounding error (TwoSum), in place
    bv = s - p
    err = torch.sub(p, s - bv)
    err += bv.neg_().add_(c)
    # to odd: the exact sum truncated (one ulp towards zero where the
    # error points there), with its last bit set where it was inexact
    s.view(torch.int64).add_(err * s < 0, alpha=-1).bitwise_or_(err != 0)
    return s.to(_F32)


def _c(v: float) -> float:
    """A constant as XLA holds it: rounded to float32."""
    return float(np.float32(v))


# Cephes' logf coefficients, as float32 (Eigen's plog_float)
_LOG_P = tuple(_c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = _c(-2.12194440e-4)
_LOG_Q2 = _c(0.693359375)


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of positive normal finite float32 values as XLA's CPU
    backend computes it: Eigen's ``plog_float`` with each product fused
    into the sum that takes it."""
    assert x.dtype == _F32
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(_F32)
    small = m < _c(0.707106781186547524)
    e = e - small.to(_F32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    # x and x3 as float64 once, for the products that take them
    x64, x3 = x.to(_F64), (x2 * x).to(_F64)
    p = _LOG_P
    y = fma(fma(x64, p[0], p[1]), x64, p[2])
    y1 = fma(fma(x64, p[3], p[4]), x64, p[5])
    y2 = fma(fma(x64, p[6], p[7]), x64, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    # -0.5 * x2 and _LOG_Q2 * e (9 bits by 8) are exact in float32, so
    # the fused sums are float32 adds
    x = (x2 * -0.5 + x) + y
    return _LOG_Q2 * e + x


# XLA's log1p: a Cephes rational below sqrt(2) - 1, log(1 + x) above
_LOG1P_NUM = tuple(_c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
_LOG1P_SMALL = _c(0.41421356237309504880)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    x = x.to(_F64)
    p = coeffs[0]
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 values in (-1, 0] as XLA's CPU backend
    computes it (its elemental ``log-plus-one``): both branches on every
    element, and a select keeps the one XLA takes."""
    assert x.dtype == _F32
    small = torch.abs(x) < _LOG1P_SMALL
    return torch.where(small, _log1p_small(x), _log1p_large(x))


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    # x2 * -0.5 is exact in float32: the fused sum is a float32 add
    return x + (x2 * -0.5 + (x * x2) * r)


def _log1p_large(x: torch.Tensor) -> torch.Tensor:
    return log(x + 1.0)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (XLA's CPU ``sqrt`` is
    the hardware's; PyTorch's vectorized CPU ``sqrt`` is not always
    correctly rounded): taken in float64 and rounded once more, which
    float64's 29 extra bits make exact."""
    return torch.sqrt(x.to(_F64)).to(_F32)


# XLA's ErfInv32 (Giles' single-precision approximation)
_ERFINV_LT5 = tuple(_c(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_c(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of float32 values in (-1, 1) as XLA's CPU
    backend computes it."""
    assert x.dtype == _F32
    w = -log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    w = w.to(_F64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(lt, a, b))
    return p * x
