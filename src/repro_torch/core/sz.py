"""SZ-style prediction-based error-bounded lossy compressor (paper §2, §5.1):
the host byte codec.

Port of the byte-codec half of `repro.core.sz`. Pipeline: linear
quantization (delta = 2*eb, float64) -> integer Lorenzo -> canonical
Huffman. The containers are byte-identical to the reference's: ``SZJ1``
for the host coder and ``SZJ2`` for streams whose quantization ran on the
device in float32 (`core/device_encode.py`); `sz_decompress` reads both.

The pointwise guarantee |x - x~| <= eb holds by construction: the integer
Lorenzo transform is lossless, so the only error is quantization.
"""

from __future__ import annotations

import struct

import numpy as np

from . import entropy as _entropy

#: symbols: 0 = escape (outlier), 1..2R+1 = residual shifted by R+1
RESIDUAL_RADIUS = 32767
#: host-coder container magic
_MAGIC = b"SZJ1"
#: device-encoded container: the SZJ1 layout, quantized on the device in f32
DEVICE_MAGIC = b"SZJ2"


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
