"""float32 math as the reference's compiled programs take it on the CPU.

The reference runs its estimators through XLA, whose float32 `log`,
`log2` and `exp2` are not the correctly rounded functions torch calls:

* `log` is XLA's own polynomial (Cephes' `logf`) with FMAs, and `log2`
  is it times f32(1 / ln 2), one ulp below the integer at 2^+-13,
  2^+-15, 2^+-26, 2^+-27, 2^+-30, 2^+-31, ... (and off elsewhere);
* `exp2` is exp(p * ln 2), exact at integer p only in [-12, 12].

A floor or ceil of a `log2`, and a power of two built by `exp2`, decide
bit planes and block exponents in the ZFP estimates, so the estimate paths
(`estimator`, `embedded`'s estimate functions, `zfp.zfp_stats`) take these
forms. The byte coders and the ZFP device encoder, whose codes must equal
the host coder's float64 numpy ones, take torch's exact `log2`/`exp2`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: float32 ln 2, the constant the reference's `jnp.exp2` multiplies by
_LN2_F32 = float(np.float32(math.log(2.0)))


def _exp2(p: torch.Tensor) -> torch.Tensor:
    """2^p as the reference's compiled estimator evaluates `jnp.exp2`: XLA
    lowers it to exp(p * ln 2) in float32, which is exact for integer p only
    in [-12, 12] (2^-13 comes out 8 ulps low). On the CPU this gives the
    reference's bits at every integer p from -125 to 127. The estimates
    follow it so that they land where the reference's do: a plane step a
    few ulps off moves the estimated PSNR by up to ~0.01 dB, across the
    0.05 dB grid that fixes the SZ bin (`sz_delta_for_psnr`)."""
    return torch.exp(p.to(torch.float32) * _LN2_F32)


def _f32_bits(u: int) -> float:
    """The float32 constant whose bits are `u`."""
    return float(np.array([u], np.uint32).view(np.float32)[0])


#: XLA's CPU float32 log (Cephes' logf): x = m 2^e with m in [sqrt(1/2),
#: sqrt 2), log(m) from a degree-8 polynomial in m - 1, and log 2 split in
#: two, q2 + q1. The coefficients, in the order the code uses them.
_XLA_LOG_P = tuple(
    _f32_bits(u)
    for u in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
              0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
)
_XLA_LOG_Q1, _XLA_LOG_Q2 = _f32_bits(0xB95E8083), _f32_bits(0x3F318000)
_SQRT_HALF_F32 = _f32_bits(0x3F3504F3)


def _round32(v: torch.Tensor) -> torch.Tensor:
    """A double tensor rounded to float32, held in double. `_round32(a * b
    + c)` of float32 values is the float32 FMA XLA's CPU code uses (one
    rounding): the product is exact in double, and the double sum rounds
    to the same float32 but for ties too rare to meet."""
    return v.float().double()


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log bit for bit as the reference's compiled programs
    take it on the CPU (XLA's polynomial, with its FMAs; subnormal inputs
    count as zero). torch's log differs from it by an ulp on about one
    value in seven, enough to move the controller's secant. The chain runs
    in double, each step rounded to float32 where XLA's rounds (an FMA's
    product is exact in double), in as few torch ops as that allows."""
    x = x.float()
    tiny = torch.finfo(torch.float32).tiny
    bits = x.clamp_min(tiny).view(torch.int32)  # NaN and inf: replaced below
    e = ((bits >> 23) - 126).float()
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # [1/2, 1)
    low = m < _SQRT_HALF_F32
    t = ((m - 1.0) + torch.where(low, m, 0.0)).double()
    e = (e - low.float()).double()
    t2 = _round32(t * t)
    t3 = _round32(t2 * t)
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _XLA_LOG_P
    y = _round32(_round32(t * p0 + p1) * t + p2)
    y1 = _round32(_round32(t * p3 + p4) * t + p5)
    y = _round32(torch.addcmul(y1, y, t3))
    y2 = _round32(_round32(t * p6 + p7) * t + p8)
    y = _round32(torch.addcmul(y2, t3, y))
    y = _round32(torch.addcmul(_round32(e * _XLA_LOG_Q1), y, t3))
    r = _round32(_round32(t2 * -0.5 + t) + y)
    r = (e * _XLA_LOG_Q2 + r).float()
    normal = (x >= tiny) & (x < math.inf)
    # the rest as XLA has them: zero and subnormals -inf, inf inf, x < 0 NaN
    return torch.where(normal, r, torch.log(torch.where(x < tiny, torch.clamp_max(x, 0.0), x)))


#: XLA takes log2 as log(x) * f32(1 / ln 2)
_INV_LN2_F32 = float(np.float32(1.0 / math.log(2.0)))


def _xla_log2(x: torch.Tensor) -> torch.Tensor:
    """float32 log2 as the reference's compiled estimators take it (a
    floor or ceil of it moves a bit plane where torch's exact log2 of a
    power of two, or of a value an ulp from one, lands on the other side)."""
    return _xla_log(x) * _INV_LN2_F32
