"""Stage II static vector quantization (paper §5.1), in torch.

Port of `repro.core.quantize`: the three analyzed quantizer families
(§5.1.4), each returning integer codes, each `dequantize_*` the bin's
reconstruction (the paper's "estimated value"):

* linear   — SZ's equal-width bins, width delta = 2*eb (error <= eb);
* log      — log-scale bins (finer near zero; higher PSNR, worse entropy);
* equiprob — equal-probability bins (NUMARCK-style).

Everything runs in float32, as the reference does without 64-bit mode
(its float64 casts are float32 there); its logs are XLA's
(`xla_f32._xla_log`), and its quantiles `jnp.quantile`'s linear
interpolation in its own order, so codes and edges match it bit for bit.
"""

from __future__ import annotations

import torch

from .xla_f32 import _xla_log

# -- linear (SZ) ------------------------------------------------------------


def linear_quantize(x: torch.Tensor, eb: float) -> torch.Tensor:
    """Prequantization onto the uniform grid with bin size 2*eb, rounding
    half to even: |x - dequantize(quantize(x))| <= eb by construction."""
    delta = 2.0 * eb
    return torch.round(x.to(torch.float32) / delta).to(torch.int32)


def linear_dequantize(codes: torch.Tensor, eb: float, dtype=torch.float32) -> torch.Tensor:
    return (codes.to(torch.float32) * (2.0 * eb)).to(dtype)


# -- log-scale (§5.1.4) ------------------------------------------------------


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def log_quantize(x: torch.Tensor, n_bins_half: int, max_abs: float,
                 dynamic_range: float = 1e6) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-scale quantization with ~2n-1 bins refining toward zero: bin k
    covers max_abs * (b^(k-1), b^k] for k in (-n+1, 0]; |x| below the
    dynamic-range floor maps to the zero bin. Returns (codes, [b, max])."""
    n = n_bins_half
    x = x.to(torch.float32)
    mx = torch.clamp_min(_f32(max_abs, x.device), 1e-30)
    b = torch.exp(_xla_log(_f32(dynamic_range, x.device)) / n)
    mag = torch.abs(x) / mx
    k = torch.ceil(_xla_log(torch.clamp_min(mag, 1e-30)) / _xla_log(b))  # <= 0
    k = torch.clamp(k, -(n - 1), 0)
    dead = mag < 1.0 / dynamic_range
    code = torch.where(dead, 0.0, (k + n) * torch.sign(x))
    return code.to(torch.int32), torch.stack([b, mx])


def log_dequantize(codes: torch.Tensor, b_mx: torch.Tensor, dtype=torch.float32,
                   n_bins_half: int | None = None) -> torch.Tensor:
    """Inverse: geometric-midpoint reconstruction. `n_bins_half` must match
    the encoder's (default: inferred from the largest code)."""
    b, mx = b_mx[0], b_mx[1]
    n = n_bins_half if n_bins_half is not None else torch.max(torch.abs(codes))
    k = torch.abs(codes).to(torch.float32) - n  # <= 0
    mid = torch.where(codes == 0, 0.0, torch.sign(codes).to(torch.float32) * mx * b ** (k - 0.5))
    return mid.to(dtype)


# -- equal-probability (NUMARCK-style, §5.1.4) --------------------------------


def equiprob_edges(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin edges at equally spaced quantiles (the clustering approximation),
    by `jnp.quantile`'s linear interpolation: position q * (n - 1) between
    the sorted values at its floor and ceil, weighted as XLA's CPU code
    computes it (the high term fused into one FMA). The quantiles are
    `jnp.linspace`'s as XLA evaluates it: i times the float32 reciprocal of
    n_bins (its division by a constant), then 1."""
    flat = torch.sort(x.reshape(-1).to(torch.float32)).values
    dev = flat.device
    step = torch.reciprocal(torch.tensor(float(n_bins), dtype=torch.float32, device=dev))
    qs = torch.cat([torch.arange(n_bins, dtype=torch.float32, device=dev) * step,
                    torch.ones(1, dtype=torch.float32, device=dev)])
    pos = qs * (flat.numel() - 1)
    low = torch.floor(pos)
    high_w = pos - low
    lo = flat[low.long().clamp(0, flat.numel() - 1)]
    hi = flat[torch.ceil(pos).long().clamp(0, flat.numel() - 1)]
    return ((lo * (1.0 - high_w)).double() + hi.double() * high_w.double()).float()


def equiprob_quantize(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(edges, x.reshape(-1).to(edges.dtype), right=True) - 1
    return torch.clamp(idx, 0, edges.shape[0] - 2).reshape(x.shape).to(torch.int32)


def equiprob_dequantize(codes: torch.Tensor, edges: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    mids = (edges[:-1] + edges[1:]) / 2.0
    return mids[codes.long()].to(dtype)


__all__ = [
    "equiprob_dequantize",
    "equiprob_edges",
    "equiprob_quantize",
    "linear_dequantize",
    "linear_quantize",
    "log_dequantize",
    "log_quantize",
]
