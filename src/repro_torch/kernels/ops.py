"""Public kernel-tier entry: rank dispatch for the Lorenzo encode.

Port of `repro.kernels.ops.lorenzo_encode`. One shared predicate,
`pallas_rank`, decides which shapes ride the kernels: every non-empty 2-D
or 3-D shape goes to K1 or K2, every other rank takes the plain
`lorenzo_forward` path. The CUDA kernels mask ragged edges themselves, so
none of the reference's TPU padding and tile clamping is needed.
"""

from __future__ import annotations

import torch

from ..core.transforms import lorenzo_forward
from . import lorenzo


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
    delta = 2.0 * torch.as_tensor(eb, dtype=torch.float32, device=x.device)
    return lorenzo_forward(torch.round(x / delta)).to(torch.int32)
