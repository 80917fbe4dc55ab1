"""SZ-style prediction-based error-bounded lossy compressor (paper §2, §5.1):
the host byte codec and the rate/distortion statistics.

Port of `repro.core.sz`. `sz_stats` computes the SZ path's exact
reconstruction, entropy rate and PSNR in torch (float32, as the
reference's in-graph form). Pipeline: linear
quantization (delta = 2*eb, float64) -> integer Lorenzo -> canonical
Huffman. The containers are byte-identical to the reference's: ``SZJ1``
for the host coder and ``SZJ2`` for streams whose quantization ran on the
device in float32 (`core/device_encode.py`); `sz_decompress` reads both.

The pointwise guarantee |x - x~| <= eb holds by construction: the integer
Lorenzo transform is lossless, so the only error is quantization.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from . import entropy as _entropy
from .transforms import lorenzo_forward
from .xla_f32 import _xla_log, _xla_log2

#: symbols: 0 = escape (outlier), 1..2R+1 = residual shifted by R+1
RESIDUAL_RADIUS = 32767
#: host-coder container magic
_MAGIC = b"SZJ1"
#: device-encoded container: the SZJ1 layout, quantized on the device in f32
DEVICE_MAGIC = b"SZJ2"


@dataclass
class SZStats:
    bitrate: torch.Tensor      # bits/value (entropy + 0.5 offset + outliers)
    psnr: torch.Tensor         # actual PSNR of the reconstruction
    mse: torch.Tensor
    recon: torch.Tensor        # reconstruction (error <= eb pointwise)
    outlier_frac: torch.Tensor


def sz_stats(x: torch.Tensor, eb, hist_radius: int = RESIDUAL_RADIUS) -> SZStats:
    """Exact rate/distortion of the SZ path: float32 codes (round half to
    even) on the 2*eb grid, their Lorenzo residuals' entropy over the
    2*radius+1 integer bins the reference's `jnp.histogram` takes (residuals
    clipped into them; those beyond count as outliers at 64 bits), plus the
    0.5-bit Huffman offset (paper §6.2); the PSNR over the value range."""
    xf = x.to(torch.float32)
    delta = 2.0 * torch.as_tensor(eb, dtype=torch.float32, device=xf.device)
    codes = torch.round(xf / delta)
    recon = (codes * delta).to(torch.float32)
    d = lorenzo_forward(codes)
    clipped = torch.clamp(d, -hist_radius, hist_radius)
    outlier = torch.abs(d) > hist_radius
    # unit bins centred on the integers -R..R: bin = residual + R
    hist = torch.bincount((clipped + hist_radius).reshape(-1).long(),
                          minlength=2 * hist_radius + 1)
    p = hist.to(torch.float32) / torch.clamp_min(hist.sum(), 1)
    ent = -torch.sum(torch.where(p > 0, p * _xla_log2(torch.clamp_min(p, 1e-30)), 0.0))
    ofrac = torch.mean(outlier.to(torch.float32))
    bitrate = ent + 0.5 + ofrac * 64.0
    err = xf - recon
    mse = torch.mean(torch.square(err))
    vr = torch.clamp_min(torch.max(xf) - torch.min(xf), 1e-30)
    ratio = torch.clamp_min(mse, 1e-60) / (vr * vr)
    psnr = -10.0 * (_xla_log(ratio) * _INV_LN10_F32)
    return SZStats(bitrate=bitrate, psnr=psnr, mse=mse, recon=recon, outlier_frac=ofrac)


#: XLA takes log10 as log(x) * f32(1 / ln 10)
_INV_LN10_F32 = float(np.float32(1.0 / np.log(10.0)))


def _lorenzo_fwd_np(k: np.ndarray) -> np.ndarray:
    out = k
    for ax in range(k.ndim):
        out = np.diff(out, axis=ax, prepend=np.zeros_like(np.take(out, [0], axis=ax)))
    return out


def _lorenzo_inv_np(d: np.ndarray) -> np.ndarray:
    out = d
    for ax in range(d.ndim):
        out = np.cumsum(out, axis=ax)
    return out


def sz_container(
    shape: tuple[int, ...],
    delta: float,
    table: "_entropy.HuffmanTable",
    payload: bytes,
    outliers: np.ndarray,
    *,
    magic: bytes = _MAGIC,
) -> bytes:
    """Assemble the self-describing SZ container around an already-encoded
    Huffman payload (shared by the host and the device Stage III)."""
    outliers = np.asarray(outliers, dtype=np.int64)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    hdr = struct.pack(
        "<4sBdQI", magic, len(shape), float(delta), size, len(outliers)
    ) + struct.pack(f"<{len(shape)}q", *shape)
    tbl = table.to_bytes()
    return b"".join(
        [
            hdr,
            struct.pack("<I", len(tbl)), tbl,
            struct.pack("<Q", len(payload)), payload,
            outliers.tobytes(),
        ]
    )


def sz_encode_residuals(
    d: np.ndarray, shape: tuple[int, ...], delta: float, *, magic: bytes = _MAGIC
) -> bytes:
    """Stage III on precomputed Lorenzo residuals: symbols, Huffman table,
    payload, outlier section, container."""
    d = np.asarray(d).reshape(-1).astype(np.int64)
    esc_mask = np.abs(d) > RESIDUAL_RADIUS
    syms = np.where(esc_mask, 0, d + RESIDUAL_RADIUS + 1).astype(np.int64)
    freqs = np.bincount(syms, minlength=2 * RESIDUAL_RADIUS + 2)
    table = _entropy.build_table(freqs)
    payload = _entropy.encode(syms, table)
    return sz_container(shape, delta, table, payload, d[esc_mask], magic=magic)


def sz_compress(x: np.ndarray, eb: float) -> bytes:
    """Error-bounded compression to a self-describing byte stream."""
    if not eb > 0:
        raise ValueError(f"error bound must be positive, got {eb}")
    x = np.asarray(x, dtype=np.float32)
    delta = 2.0 * float(eb)
    codes = np.round(np.nan_to_num(x.astype(np.float64) / delta)).astype(np.int64)
    d = _lorenzo_fwd_np(codes)
    return sz_encode_residuals(d, x.shape, delta)


def sz_decompress(buf: bytes) -> np.ndarray:
    off = 0
    magic, ndim, delta, size, n_out = struct.unpack_from("<4sBdQI", buf, off)
    if magic not in (_MAGIC, DEVICE_MAGIC):
        raise ValueError(f"not an SZJ1/SZJ2 stream (magic {magic!r})")
    off += struct.calcsize("<4sBdQI")
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    (tbl_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    table = _entropy.HuffmanTable.from_bytes(buf[off : off + tbl_len])
    off += tbl_len
    (pay_len,) = struct.unpack_from("<Q", buf, off)
    off += 8
    syms = _entropy.decode(buf[off : off + pay_len], table, size)
    off += pay_len
    outliers = np.frombuffer(buf[off : off + 8 * n_out], dtype=np.int64)
    d = syms - (RESIDUAL_RADIUS + 1)
    d[syms == 0] = outliers
    codes = _lorenzo_inv_np(d.reshape(shape))
    return (codes.astype(np.float64) * delta).astype(np.float32)


def sz_compressed_bits(buf: bytes) -> int:
    return 8 * len(buf)
