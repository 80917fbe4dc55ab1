"""Public kernel-tier entry: rank dispatch for the Lorenzo encode and
decode and the fused BOT.

Port of `repro.kernels.ops`. One shared predicate, `pallas_rank`, decides
which shapes ride the kernels: every non-empty 2-D or 3-D shape goes to
its kernel (K1/K2 for `lorenzo_encode`, K3/K4 for `lorenzo_decode`, K5/K6
for `bot_fused`), every other rank takes the plain path. The CUDA kernels
mask ragged edges themselves (the BOT kernels count values outside the
field as zero, as the reference's zero padding does), so none of the
reference's TPU padding and tile clamping is needed.
"""

from __future__ import annotations

import torch

from ..core.transforms import lorenzo_inverse
from ..core.zfp import zfp_stats
from . import bot4, lorenzo
from .ref import lorenzo_encode_ref, to_int32_saturating


def pallas_rank(shape: tuple[int, ...]) -> int | None:
    """The kernel tier (2 or 3) serving `shape`, or None for the plain path.
    (The name is the reference's; the tier it names is CUDA here.)"""
    nd = len(shape)
    if nd in (2, 3) and all(s > 0 for s in shape):
        return nd
    return None


def lorenzo_encode(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Quantize + n-D Lorenzo difference -> int32 codes (same shape)."""
    x = x.to(torch.float32).contiguous()
    rank = pallas_rank(tuple(x.shape))
    if rank == 2:
        return lorenzo.lorenzo2d_encode(x, eb)
    if rank == 3:
        return lorenzo.lorenzo3d_encode(x, eb)
    return lorenzo_encode_ref(x, eb)


def lorenzo_decode(d: torch.Tensor, eb: float) -> torch.Tensor:
    """Inverse Lorenzo (n-D prefix sum, float32) + dequantize -> float32
    reconstruction. The prefix sum is cast to int32 before K3/K4, saturating
    as the reference's cast does."""
    k = lorenzo_inverse(d.to(torch.float32))
    rank = pallas_rank(tuple(d.shape))
    if rank == 2:
        return lorenzo.dequantize2d(to_int32_saturating(k).contiguous(), eb)
    if rank == 3:
        return lorenzo.dequantize3d(to_int32_saturating(k).contiguous(), eb)
    return k * (2.0 * torch.as_tensor(eb, dtype=torch.float32, device=d.device))


def bot_fused(x: torch.Tensor, eb, transform: str = "zfp"):
    """Fused ZFP-style transform/truncate -> (recon, bits per block); other
    ranks than 2 and 3 return (`zfp_stats` reconstruction, None)."""
    x = x.to(torch.float32).contiguous()
    rank = pallas_rank(tuple(x.shape))
    if rank == 2:
        return bot4.bot2d_fused(x, eb, transform)
    if rank == 3:
        return bot4.bot3d_fused(x, eb, transform)
    return zfp_stats(x, eb, transform=transform).recon, None
