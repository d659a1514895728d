"""Plain PyTorch version of the 3xTF32 split product of ``csrc/tf32x3.cuh``.

The hand kernels' tile products run on the tensor cores as three TF32
passes: each f32 operand x is split into ``hi = tf32(x)`` and
``lo = tf32(x − hi)`` and the product is ``lo·hi + hi·lo + hi·hi`` with f32
accumulation (``lo·lo`` is dropped). :func:`tf32_round` is the card's
``cvt.rna.tf32.f32`` on any device, :func:`matmul_3xtf32_plain` the split
product. Tests and ``chip_smoke.py`` hold the kernels against them; no fit
calls them.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_3xtf32_plain", "tf32_round", "tf32_split"]

_HALF_ULP = 0x1000  # half of TF32's last place, in f32 bits (13 bits are dropped)
_KEEP = 0x7FFFE000  # magnitude bits TF32 keeps: 8 of exponent, 10 of mantissa


def tf32_round(x):
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to
    nearest on the low 13 mantissa bits, ties away from zero, through an
    int32 view. Subnormals round like any other magnitude; ±inf and NaN
    pass through; a finite value within half a place of the largest TF32
    number rounds to ±inf."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sign = bits & -0x80000000
    rounded = (((mag + _HALF_ULP) & _KEEP) | sign).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x − hi): x = hi + lo up to 2⁻²² |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32_plain(a, b):
    """``a @ b`` for float32 ``a`` (..., m, k) and ``b`` (..., k, n) as the
    tensor-core kernels form it: both operands split into TF32 hi and lo,
    the two cross terms summed first, then hi·hi added. The three partial
    products are exact-input f32 matmuls on this device (every factor has
    at most 11 significant bits, so each elementwise product is exact in
    f32); only the order of the sums differs from the kernels'."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
