"""Plain torch versions of the Lorenzo kernels: the CPU path of the kernel
wrappers and the oracle each CUDA kernel is held against on the card."""

from __future__ import annotations

import torch

from ..core.transforms import lorenzo_forward, lorenzo_inverse


def _delta(eb, device: torch.device) -> torch.Tensor:
    """The float32 bin size 2*eb, rounded exactly as the kernels round it."""
    return 2.0 * torch.as_tensor(eb, dtype=torch.float32, device=device)


def lorenzo_encode_ref(x: torch.Tensor, eb) -> torch.Tensor:
    """round(x/2eb) (half to even, float32) then the n-D integer Lorenzo
    difference -> int32 codes of x's shape."""
    k = torch.round(x.to(torch.float32) / _delta(eb, x.device))
    return lorenzo_forward(k).to(torch.int32)


def lorenzo_decode_ref(d: torch.Tensor, eb) -> torch.Tensor:
    """Inverse: n-D prefix sum of the codes (float32), then dequantize."""
    k = lorenzo_inverse(d.to(torch.float32))
    return k * _delta(eb, d.device)
