"""Stage II dynamic quantization: embedded (bit-plane) coding (paper §5.2),
in torch.

Port of `repro.core.embedded`. Per 4^n block: exponent alignment, BOT,
bit-plane truncation at a power-of-two step chosen from the absolute
bound and the transform's Linf gain, and the rate of the plane-sectioned
k-prefix coder of `zfp.py` (exactly, or by the closed-form model).

The exponents, steps and bit counts are estimates: they take the
reference's XLA float32 `log2` and `exp2` (`xla_f32`), so a block whose
maximum or truncated magnitude is a power of two lands on the reference's
plane. `align_blocks(..., exact=True)` is the ZFP device encoder's form,
whose codes must equal the host coder's exact numpy ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_int_saturating
from .xla_f32 import _exp2, _xla_log2

#: header bits per block in the byte format: e_max (int16) + n_planes (uint8)
BLOCK_HEADER_BITS = 24


def _per_block(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a (nblocks,) tensor to broadcast against (nblocks, 4, ..)."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def block_exponent(blocks: torch.Tensor, *, exact: bool = False) -> torch.Tensor:
    """e s.t. 2^e >= max|block| > 2^(e-1) (by the reference's XLA `log2`,
    or torch's with `exact`); shape (nblocks,). Empty-safe."""
    n = blocks.ndim - 1
    mx = torch.amax(blocks.abs(), dim=tuple(range(1, n + 1)))
    mx = torch.clamp_min(mx, 1e-30)
    return to_int_saturating(torch.ceil((torch.log2 if exact else _xla_log2)(mx)))


def align_blocks(
    blocks: torch.Tensor, *, exact: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize each block into [-1, 1] by its power-of-two exponent. The
    estimates take the reference's XLA `log2`/`exp2`; ``exact=True`` takes
    torch's exact ones, as the host coder's numpy does (the device
    encoder)."""
    e = block_exponent(blocks, exact=exact)
    scale = torch.exp2(-e.to(blocks.dtype)) if exact else _exp2(-e).to(blocks.dtype)
    return blocks * _per_block(scale, blocks.ndim), e


def plane_step(eb, e_max: torch.Tensor, linf_gain_n: float) -> torch.Tensor:
    """Power-of-two truncation step in normalized block space (float32),
    small enough that the inverse BOT keeps |error| <= eb pointwise, with
    the reference's XLA `exp2` and `log2`."""
    raw = eb / (_exp2(e_max) * linf_gain_n)
    return _exp2(torch.floor(_xla_log2(torch.clamp_min(raw, 2.0**-60))))


def truncate_planes(coeffs: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Truncate coefficients toward zero at the bit-plane boundary `step`."""
    s = _per_block(step, coeffs.ndim).to(coeffs.dtype)
    return torch.trunc(coeffs / s) * s


def reconstruct_truncated(coeffs: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Decoder-side reconstruction: midpoint of the truncated magnitude bin
    (m = trunc(|c|/s); c~ = sign*(m+.5)*s for m > 0, else 0)."""
    s = _per_block(step, coeffs.ndim).to(coeffs.dtype)
    m = torch.trunc(coeffs.abs() / s)
    zero = torch.zeros((), dtype=coeffs.dtype, device=coeffs.device)
    return torch.sign(coeffs) * torch.where(m > 0, (m + 0.5) * s, zero)


def significant_bits(coeffs: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """n_sb per coefficient: encoded bits between its MSB plane and the
    truncation plane. Shape = coeffs.shape, float32."""
    s = _per_block(step, coeffs.ndim).to(torch.float32)
    q = coeffs.to(torch.float32).abs() / s
    nb = torch.floor(_xla_log2(torch.clamp_min(q, 1.0))) + 1.0
    return torch.where(q >= 1.0, nb, torch.zeros_like(nb))


def degree_order(nd: int) -> np.ndarray:
    """ZFP's total-degree coefficient ordering within a 4^nd block: low-degree
    (high-energy) coefficients first."""
    idx = np.indices((4,) * nd).reshape(nd, -1).sum(axis=0)
    return np.argsort(idx, kind="stable")


def k_width(bsz: int) -> int:
    """Bits of the k field, which counts in [0, bsz]."""
    return int(np.ceil(np.log2(bsz + 1)))


def exact_coder_bits_blocks(
    coeffs: torch.Tensor, step: torch.Tensor, max_planes: int = 31
) -> torch.Tensor:
    """Exact per-block bit count of the plane-sectioned k-prefix coder in
    `zfp.py` (31-plane loop; magnitudes beyond 2^31 saturate). Shape
    (nblk,), float32 — mirrors `_emit_planes` plane by plane."""
    n = coeffs.ndim - 1
    bsz = 4**n
    w = k_width(bsz)
    nblk = coeffs.shape[0]
    s = _per_block(step, coeffs.ndim).to(torch.float32)
    mf = torch.trunc(coeffs.to(torch.float32).abs() / s)
    # saturate at 2^31 - 1 like the reference's float -> int32 conversion
    mf = torch.clamp_max(mf, 2.0**31)
    m = torch.clamp_max(mf.to(torch.int64), 2**31 - 1).to(torch.int32)
    order = torch.as_tensor(degree_order(n), device=coeffs.device)
    m = m.reshape(nblk, bsz)[:, order]
    mx = torch.amax(m, dim=1)
    mxf = torch.clamp_min(mx.to(torch.float32), 1.0)
    nsb = torch.where(
        mx > 0, torch.floor(_xla_log2(mxf)) + 1.0, torch.zeros_like(mxf)
    ).to(torch.int32)
    total = torch.zeros((nblk,), dtype=torch.float32, device=coeffs.device)
    for p in range(max_planes):
        active = nsb > p
        act = active[:, None]
        sig_prev = (m >> (p + 1)) > 0
        bit_p = (m >> p) & 1
        nref = torch.sum((act & sig_prev).to(torch.float32), dim=1)
        rem = act & ~sig_prev
        has_rem = torch.any(rem, dim=1) & active
        rank = torch.cumsum(rem.to(torch.int32), dim=1, dtype=torch.int32) - 1
        newly = rem & (bit_p == 1)
        k = torch.amax(torch.where(newly, rank + 1, torch.zeros_like(rank)), dim=1)
        total = total + nref + w * has_rem.to(torch.float32)
        total = total + k.to(torch.float32) + torch.sum(newly.to(torch.float32), dim=1)
    return total + BLOCK_HEADER_BITS


def exact_coder_bits(
    coeffs: torch.Tensor, step: torch.Tensor, max_planes: int = 31
) -> torch.Tensor:
    """Total exact coder bits over all blocks (sum of the per-block counts)."""
    return torch.sum(exact_coder_bits_blocks(coeffs, step, max_planes))


def block_bits(coeffs: torch.Tensor, step: torch.Tensor, sign_bits: bool = True) -> torch.Tensor:
    """Closed-form bits per block of the k-prefix coder: header + w bits per
    visited plane + sum(n_sb) + 2 bits per significant coefficient."""
    n = coeffs.ndim - 1
    bsz = 4**n
    w = k_width(bsz)
    nsb = significant_bits(coeffs, step)
    axes = tuple(range(1, n + 1))
    max_planes = torch.amax(nsb, dim=axes)
    sig = torch.sum(nsb, dim=axes)
    nsig = torch.sum((nsb > 0).to(torch.float32), dim=axes)
    bits = BLOCK_HEADER_BITS + w * max_planes + sig
    if sign_bits:
        bits = bits + 2.0 * nsig
    return bits
