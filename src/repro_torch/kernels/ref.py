"""Plain torch versions of the port's kernels: the CPU path of the kernel
wrappers and the oracle each CUDA kernel is held against on the card.

The BOT versions take the kernels' float32 steps in the kernels' order, so
kernel and plain version agree bit for bit: exponents from `torch.frexp`
and powers of two built from their bit patterns (never `log2`/`exp2`), the
4-point contractions of `block_transform_nd` (explicit pairwise sums, no
einsum or matmul), and true divisions where the reference divides.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import to_int_saturating
from ..core.transforms import (
    block_transform_nd,
    bot_linf_gain,
    bot_matrix,
    lorenzo_forward,
    lorenzo_inverse,
)

#: header bits per block (`core.embedded.BLOCK_HEADER_BITS`)
BLOCK_HEADER_BITS = 24.0


def _delta(eb, device: torch.device) -> torch.Tensor:
    """The float32 bin size 2*eb, rounded exactly as the kernels round it."""
    return 2.0 * torch.as_tensor(eb, dtype=torch.float32, device=device)


def to_int32_saturating(v: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA's `astype(int32)` and the card's
    `cvt.rzi.s32.f32` convert it: truncated toward zero, saturated at the
    int32 limits (+-inf included), NaN -> 0."""
    return to_int_saturating(v, torch.int32)


def lorenzo_encode_ref(x: torch.Tensor, eb) -> torch.Tensor:
    """round(x/2eb) (half to even, float32) then the n-D integer Lorenzo
    difference -> int32 codes of x's shape (saturating cast).

    The float32 difference is formed in the TPU kernels' order: in 2-D
    ``((k - up) - left) + ul`` (`_encode_kernel`), which above 2^24 rounds
    otherwise than one axis at a time; in other ranks one zero-padded
    backward difference per axis (`_encode3d_kernel` in 3-D)."""
    k = torch.round(x.to(torch.float32) / _delta(eb, x.device))
    if k.ndim == 2:
        kp = F.pad(k, (1, 0, 1, 0))  # zeros above and left of the domain
        return to_int32_saturating(((k - kp[:-1, 1:]) - kp[1:, :-1]) + kp[:-1, :-1])
    return to_int32_saturating(lorenzo_forward(k))


def lorenzo_decode_ref(d: torch.Tensor, eb) -> torch.Tensor:
    """Inverse: n-D prefix sum of the codes (float32), then dequantize."""
    k = lorenzo_inverse(d.to(torch.float32))
    return k * _delta(eb, d.device)


def dequantize_ref(k: torch.Tensor, eb) -> torch.Tensor:
    """K3/K4: float32(k) * 2eb, elementwise."""
    return k.to(torch.float32) * _delta(eb, k.device)


def pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32, exactly, for int32 k (subnormal below 2^-126, inf
    above 2^127, 0 below 2^-149): built from the bit pattern."""
    k = k.to(torch.int32)
    normal = ((torch.clamp(k, -126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(k) << torch.clamp(k + 149, 0, 22)).view(torch.float32)
    inf = torch.full_like(normal, float("inf"))
    out = torch.where(k > 127, inf, normal)
    out = torch.where(k < -126, sub, out)
    return torch.where(k < -149, torch.zeros_like(out), out)


def _zero_blocks(x: torch.Tensor) -> torch.Tensor:
    """(d1,..,dn) -> (ceil(d1/4), .., ceil(dn/4), 4, .., 4), zero-padded at
    the far edges (the reference's `jnp.pad`, not edge replication)."""
    nd = x.ndim
    pads = []
    for s in reversed(x.shape):
        pads += [0, (-s) % 4]
    xp = F.pad(x, pads) if any(pads) else x
    split = []
    for s in xp.shape:
        split += [s // 4, 4]
    perm = [2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
    return xp.reshape(split).permute(perm)


def _unblock(blocks: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    nd = len(shape)
    perm = []
    for i in range(nd):
        perm += [i, nd + i]
    padded = [4 * g for g in blocks.shape[:nd]]
    x = blocks.permute(perm).reshape(padded)
    return x[tuple(slice(0, s) for s in shape)]


def bot_fused_ref(
    x: torch.Tensor, eb, transform: str = "zfp"
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (2-D) / K6 (3-D): blockize (zero pad) -> align -> BOT -> truncate
    -> (recon of x's shape, bits per block (ceil(d/4), ..)), float32."""
    nd = x.ndim
    x = x.to(torch.float32)
    b = _zero_blocks(x)
    axes = tuple(range(nd, 2 * nd))
    per_block = lambda t: t.reshape(t.shape + (1,) * nd)  # noqa: E731
    eb32 = torch.as_tensor(eb, dtype=torch.float32, device=x.device)
    gain = float(np.float32(bot_linf_gain(transform) ** nd))
    T = bot_matrix(transform)

    mx = torch.clamp_min(torch.amax(b.abs(), dim=axes), 1e-30)
    mant, ex = torch.frexp(mx)
    e = torch.where(mant == 0.5, ex - 1, ex)  # ceil(log2 mx)
    scale = pow2(-e)
    c = block_transform_nd(b * per_block(scale), T, nd)
    raw = torch.clamp_min(eb32 / (pow2(e) * gain), 2.0**-60)
    step = per_block(pow2(torch.frexp(raw).exponent - 1))  # 2^floor(log2 raw)
    m = torch.trunc(c.abs() / step)
    nsb = torch.where(m >= 1.0, torch.frexp(m).exponent.to(torch.float32), 0.0)
    w = 5.0 if nd == 2 else 7.0
    maxp = torch.amax(nsb, dim=axes)
    sig = torch.sum(nsb, dim=axes)
    nsig = torch.sum((nsb > 0).to(torch.float32), dim=axes)
    bits = ((BLOCK_HEADER_BITS + w * maxp) + sig) + 2.0 * nsig
    mag = torch.where(m > 0, (m + 0.5) * step, 0.0)
    rb = block_transform_nd(torch.where(c < 0, -mag, mag), T, nd, inverse=True)
    recon = _unblock(rb / per_block(scale), tuple(x.shape))
    return recon, bits


#: the rank-specific names of the reference's oracles (`bot_fused_ref` is
#: rank-generic)
bot2d_fused_ref = bot3d_fused_ref = bot_fused_ref
