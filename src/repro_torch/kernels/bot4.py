"""Fused ZFP-style block transform + bit-plane truncation: CUDA kernels for
Hopper and their wrappers (K5 2-D and K6 3-D of the port).

The kernels (``csrc/bot4.cu``) replace the Pallas TPU kernels
`repro.kernels.bot4.bot2d_fused` and `bot3d_fused`: per 4x4 (or 4x4x4)
block, exponent alignment, the transform T(t) along every block axis,
truncation at the conservative power-of-two plane step, the closed-form
`block_bits` rate, and the midpoint reconstruction, in one pass. Ragged
edges count as zero, as the reference's zero padding does; nothing is
padded in memory.

Each wrapper takes a contiguous float32 tensor of its rank and the bound
`eb` (a float, or a one-element float32 tensor that may stay on the card).
A CUDA tensor launches the kernel on the current stream, or raises; a CPU
tensor — the caller asked for the CPU — runs the plain torch version in
`ref.py`. `LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.transforms import BOT_PRESETS, bot_linf_gain, bot_matrix
from . import _build
from .lorenzo import _check, count_launch
from .ref import bot_fused_ref

#: kernel launches per kernel since the last reset (CPU calls do not count)
LAUNCHES = {"bot2d_fused": 0, "bot3d_fused": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _constants(transform: str, nd: int) -> tuple[ctypes.Array, ctypes.c_float]:
    """The kernel's constant arguments for (transform, rank): T(t) as 16
    float32 values, row-major, and bot_linf_gain(t)^nd rounded to float32."""
    T = (ctypes.c_float * 16)(*np.asarray(bot_matrix(transform), np.float32).reshape(-1))
    return T, ctypes.c_float(float(np.float32(bot_linf_gain(transform) ** nd)))


def _launch(name: str, x: torch.Tensor, eb, transform: str):
    nd = x.ndim
    recon = torch.empty_like(x)
    bits = torch.empty(tuple(-(-s // 4) for s in x.shape), dtype=torch.float32,
                       device=x.device)
    if x.numel() == 0:
        return recon, bits
    eb_dev = torch.as_tensor(eb, dtype=torch.float32, device=x.device).reshape(1)
    T, gain = _constants(transform, nd)
    fn = getattr(_build.load("bot4"), name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), recon.data_ptr(), bits.data_ptr(), *x.shape,
                eb_dev.data_ptr(), T, gain, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, name)
    return recon, bits


def _fused(name: str, nd: int, x: torch.Tensor, eb, transform: str):
    _check(x, nd, name)
    if transform not in BOT_PRESETS:
        raise ValueError(f"{name}: unknown transform {transform!r}; one of {sorted(BOT_PRESETS)}")
    if isinstance(eb, torch.Tensor) and eb.numel() != 1:
        raise ValueError(f"{name}: eb must be one value, got shape {tuple(eb.shape)}")
    if x.device.type == "cpu":
        return bot_fused_ref(x, eb, transform)
    return _launch(name, x, eb, transform)


def bot2d_fused(x: torch.Tensor, eb, transform: str = "zfp"):
    """K5: f32 (m, n) -> (recon f32 (m, n), bits f32 (ceil(m/4), ceil(n/4)))."""
    return _fused("bot2d_fused", 2, x, eb, transform)


def bot3d_fused(x: torch.Tensor, eb, transform: str = "zfp"):
    """K6: f32 (z, m, n) -> (recon f32 (z, m, n), bits f32 (ceil(z/4),
    ceil(m/4), ceil(n/4)))."""
    return _fused("bot3d_fused", 3, x, eb, transform)
