"""Stage I lossless transformations (paper §4), in torch.

Port of `repro.core.transforms`:

* PBT — the prequantized integer Lorenzo transform as one zero-padded
  backward difference per axis, and its inverse as inclusive prefix sums.
* BOT — the paper's parametric 4x4 orthogonal transform T(t), applied one
  axis at a time to 4^n blocks.

`block_transform_nd` writes each 4-term contraction out as explicit
multiplies and adds in the order the reference's f32 dot takes,
``(p0 + p1) + (p2 + p3)``, so float32 coefficients agree bit for bit and
no tensor-core (TF32) path is ever involved.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# PBT: n-dimensional Lorenzo transform as separable first-order differences
# ---------------------------------------------------------------------------


def lorenzo_forward(x: torch.Tensor) -> torch.Tensor:
    """n-D Lorenzo residual: a zero-padded backward difference along every
    axis (lossless over integers)."""
    out = x
    for axis in range(x.ndim):
        prev = torch.roll(out, 1, dims=axis)
        prev.narrow(axis, 0, 1).zero_()  # roll copied, so this is local
        out = out - prev
    return out


def lorenzo_predict(x: torch.Tensor) -> torch.Tensor:
    """The Lorenzo *prediction* of each point from its original real
    neighbours, ``x - lorenzo_forward(x)`` (estimator diagnostics)."""
    return x - lorenzo_forward(x)


def lorenzo_inverse(d: torch.Tensor) -> torch.Tensor:
    """Inverse PBT: inclusive prefix sum along every axis, in `d`'s dtype."""
    out = d
    for axis in range(d.ndim):
        out = torch.cumsum(out, dim=axis, dtype=out.dtype)
    return out


# ---------------------------------------------------------------------------
# BOT: the parametric 4x4 orthogonal transform family (paper §4.2)
# ---------------------------------------------------------------------------

#: named parameter values for T(t)
BOT_PRESETS = {
    "hwt": 0.0,
    "dct2": 0.25,
    "slant": (2.0 / math.pi) * math.atan(1.0 / 3.0),
    "high_corr": (2.0 / math.pi) * math.atan(1.0 / 2.0),
    "wht": 0.5,
    "zfp": (2.0 / math.pi) * math.atan(1.0 / 2.0),
}


def bot_matrix(t: float | str = "zfp") -> np.ndarray:
    """The paper's uniform parametric 4x4 orthogonal transform T(t), f64."""
    if isinstance(t, str):
        t = BOT_PRESETS[t]
    s = math.sqrt(2.0) * math.sin(math.pi / 2.0 * t)
    c = math.sqrt(2.0) * math.cos(math.pi / 2.0 * t)
    return 0.5 * np.array(
        [
            [1.0, 1.0, 1.0, 1.0],
            [c, s, -s, -c],
            [1.0, -1.0, -1.0, 1.0],
            [s, -c, c, -s],
        ],
        dtype=np.float64,
    )


def bot_linf_gain(t: float | str = "zfp") -> float:
    """Max-abs-row-sum of T^t per axis: the worst-case Linf amplification of
    the inverse transform, which sets the conservative bit-plane cutoff."""
    T = bot_matrix(t)
    return float(np.abs(T.T).sum(axis=1).max())


def block_transform_nd(
    blocks: torch.Tensor, T, n: int, inverse: bool = False
) -> torch.Tensor:
    """Apply the 1-D transform T along each of the trailing `n` axes (size 4).

    Axes are contracted one at a time, first to last; each output is
    ``(x0*M[j,0] + x1*M[j,1]) + (x2*M[j,2] + x3*M[j,3])`` with every product
    and sum rounded in `blocks`' dtype.
    """
    M = np.asarray(T.T if inverse else T)
    np_dtype = np.float32 if blocks.dtype == torch.float32 else np.float64
    coef = M.astype(np_dtype).tolist()  # python floats exact in that dtype
    out = blocks
    for axis in range(blocks.ndim - n, blocks.ndim):
        xs = [out.select(axis, k) for k in range(4)]
        rows = [
            (xs[0] * coef[j][0] + xs[1] * coef[j][1])
            + (xs[2] * coef[j][2] + xs[3] * coef[j][3])
            for j in range(4)
        ]
        out = torch.stack(rows, dim=axis)
    return out


# ---------------------------------------------------------------------------
# Blocking: split an n-D field into 4^n blocks (pad edges), and back
# ---------------------------------------------------------------------------


def blockize(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(d1,...,dn) -> (nblocks, 4, ..., 4). Edge blocks are padded by
    replicating the last valid element along each axis."""
    ndim = x.ndim
    for axis, s in enumerate(x.shape):
        pad = (-s) % 4
        if pad:
            edge = x.narrow(axis, s - 1, 1)
            reps = [1] * ndim
            reps[axis] = pad
            x = torch.cat([x, edge.repeat(reps)], dim=axis)
    shape = tuple(x.shape)
    new_shape = []
    for s in shape:
        new_shape += [s // 4, 4]
    x = x.reshape(new_shape)
    perm = [2 * i for i in range(ndim)] + [2 * i + 1 for i in range(ndim)]
    x = x.permute(perm)
    nblk = int(np.prod(x.shape[:ndim]))
    return x.reshape((nblk,) + (4,) * ndim), shape


def unblockize(
    blocks: torch.Tensor, padded_shape: tuple[int, ...], orig_shape: tuple[int, ...]
) -> torch.Tensor:
    ndim = len(padded_shape)
    grid = [s // 4 for s in padded_shape]
    x = blocks.reshape(tuple(grid) + (4,) * ndim)
    perm = []
    for i in range(ndim):
        perm += [i, ndim + i]
    x = x.permute(perm).reshape(padded_shape)
    return x[tuple(slice(0, s) for s in orig_shape)]
