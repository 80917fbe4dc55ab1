"""ZFP-style transform-based error-bounded lossy compressor (paper §2, §5.2).

Port of `repro.core.zfp`, two paths:

* `zfp_stats` — in-graph (torch, on the field's device) reconstruction and
  exact rate/distortion, float32, with the reference's XLA `log2`/`exp2`
  (`xla_f32`);
* `zfp_compress` / `zfp_decompress` — the host byte codec. Pipeline: 4^n
  blocking -> exponent alignment -> block orthogonal transform T(t) ->
  truncation at a conservative power-of-two plane step -> the
  plane-sectioned, degree-ordered k-prefix embedded coder, laid out
  plane-major across all blocks so encode and decode vectorize over
  blocks. Quantization runs in float64; streams (``ZFJX``) are
  byte-identical to the reference's.

Pointwise guarantee |x - x~| <= eb via the conservative plane cutoff.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..device import as_f32
from .embedded import (
    align_blocks,
    degree_order,
    exact_coder_bits,
    k_width,
    plane_step,
    reconstruct_truncated,
    significant_bits,
)
from .transforms import blockize, block_transform_nd, bot_linf_gain, bot_matrix, unblockize
from .xla_f32 import _exp2

_MAGIC = b"ZFJX"


# ---------------------------------------------------------------------------
# in-graph statistics path
# ---------------------------------------------------------------------------


@dataclass
class ZFPStats:
    bitrate: torch.Tensor
    psnr: torch.Tensor
    mse: torch.Tensor
    recon: torch.Tensor
    mean_nsb: torch.Tensor  # the paper's n_sb-bar estimate target


def zfp_stats(x: torch.Tensor, eb, transform: str = "zfp") -> ZFPStats:
    """Exact rate/distortion of the ZFP path on `x`'s device, float32
    (edge-replicated blocking, as the byte codec)."""
    xf = x.to(torch.float32)
    n = xf.ndim
    T = bot_matrix(transform)
    gain_n = bot_linf_gain(transform) ** n
    blocks, padded = blockize(xf)
    norm, e = align_blocks(blocks)
    coeffs = block_transform_nd(norm, T, n)
    step = plane_step(torch.as_tensor(eb, dtype=torch.float32, device=xf.device), e, gain_n)
    rec_coeffs = reconstruct_truncated(coeffs, step)
    total_bits = exact_coder_bits(coeffs, step)
    rec_norm = block_transform_nd(rec_coeffs, T, n, inverse=True)
    rec_blocks = rec_norm * _exp2(e).reshape((-1,) + (1,) * n)
    recon = unblockize(rec_blocks, padded, tuple(xf.shape))
    nsb = significant_bits(coeffs, step)
    mse = torch.mean(torch.square(xf - recon))
    vr = torch.clamp_min(torch.amax(xf) - torch.amin(xf), 1e-30)
    psnr = -10.0 * torch.log10(torch.clamp_min(mse, 1e-60) / (vr * vr))
    bitrate = total_bits / xf.numel()
    return ZFPStats(bitrate=bitrate, psnr=psnr, mse=mse, recon=recon, mean_nsb=torch.mean(nsb))


# ---------------------------------------------------------------------------
# host byte codec
# ---------------------------------------------------------------------------


def _prepare_blocks(x: np.ndarray, eb: float, transform: str):
    n = x.ndim
    T = bot_matrix(transform)  # float64
    gain_n = bot_linf_gain(transform) ** n
    blocks, padded = blockize(as_f32(x, torch.device("cpu")))
    blocks = blocks.numpy().astype(np.float64)
    mx = np.maximum(np.abs(blocks).reshape(blocks.shape[0], -1).max(axis=1), 1e-30)
    e = np.ceil(np.log2(mx)).astype(np.int16)
    norm = blocks * np.exp2(-e.astype(np.float64)).reshape((-1,) + (1,) * n)
    coeffs = norm
    for axis in range(1, n + 1):
        coeffs = np.moveaxis(np.tensordot(coeffs, T, axes=[[axis], [1]]), -1, axis)
    raw = eb / (np.exp2(e.astype(np.float64)) * gain_n)
    pexp = np.floor(np.log2(np.maximum(raw, 2.0**-60)))
    step = np.exp2(pexp)
    q = np.trunc(coeffs.reshape(coeffs.shape[0], -1) / step[:, None]).astype(np.int64)
    return q, e, step, padded, gain_n, T


#: blocks `_emit_planes` and `_read_planes` code at a time, on threads of
#: their own (a chunk's arrays stay in cache; numpy lets go of the GIL)
EMIT_CHUNK = 1 << 15


def _map_chunks(fn, n: int) -> list:
    """`fn` over chunks 0..n-1, in order, on up to one thread a core."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, range(n)))


def _bit_lengths(m: np.ndarray) -> np.ndarray:
    """Bits of each magnitude in `m` (int64 >= 0; 0 for 0), as int8."""
    n = np.frexp(m.astype(np.float64))[1].astype(np.int64)
    if m.size and int(m.max()) >= 1 << 53:  # a float rounded up to 2^n
        big = n > 0
        n[big] -= (m[big] >> (n[big] - 1)) == 0
    return n.astype(np.int8)


def _emit_planes(m: np.ndarray, neg: np.ndarray, nsb: np.ndarray) -> list[np.ndarray]:
    """Plane-major, degree-ordered k-prefix significance coding.

    Per plane & block: refinement bits of significant coeffs; a fixed-width
    k = 1 + rank of the last newly-significant remaining coefficient (0 if
    none); significance bits of the first k remaining coefficients only;
    signs of the newly significant. `m` must already be in degree order.

    A coefficient is significant above plane p when its bit length exceeds
    p + 1 and turns significant at p when its bit length is p + 1, so the
    significance and sign bits come from bit lengths. The blocks are coded
    `EMIT_CHUNK` at a time, each plane on its active blocks only, and each
    plane's four sections are laid out over all blocks in block order.
    """
    nblk, bsz = m.shape
    w = k_width(bsz)
    kshift = np.arange(w - 1, -1, -1, dtype=np.int64)
    maxp = int(nsb.max()) if nsb.size else 0

    def chunk(i: int) -> dict[int, list[np.ndarray]]:
        lo = i * EMIT_CHUNK
        mc, negc, nsbc = m[lo : lo + EMIT_CHUNK], neg[lo : lo + EMIT_CHUNK], nsb[lo : lo + EMIT_CHUNK]
        lens = _bit_lengths(mc)
        planes = {}
        for p in range(int(nsbc.max()) - 1, -1, -1):
            active = nsbc > p
            if not active.all():
                blk = np.flatnonzero(active)
                ma, na, la = mc[blk], negc[blk], lens[blk]
            else:
                ma, na, la = mc, negc, lens
            # 1) refinement bits of already-significant coefficients
            sig_prev = la > p + 1
            ref = ((ma[sig_prev] >> p) & 1).astype(np.uint8)
            # 2) k per active block with remaining coeffs (fixed width w)
            rem = ~sig_prev
            has_rem = rem.any(axis=1)
            rank = np.cumsum(rem, axis=1, dtype=np.int8) - 1
            newly = la == p + 1
            k = np.max(np.where(newly, rank + 1, 0), axis=1).astype(np.int64)
            kb = ((k[has_rem, None] >> kshift[None, :]) & 1).astype(np.uint8).reshape(-1)
            # 3) significance bits of the first k remaining coefficients
            test = rem & (rank < k[:, None])
            # 4) signs of newly-significant coefficients
            planes[p] = [ref, kb, newly[test].astype(np.uint8), na[newly].astype(np.uint8)]
        return planes

    chunks = _map_chunks(chunk, -(-nblk // EMIT_CHUNK))
    return [np.concatenate([c[p][i] for c in chunks if p in c] or [np.zeros(0, np.uint8)])
            for p in range(maxp - 1, -1, -1) for i in range(4)]


def _read_planes(bits: np.ndarray, pos: int, nblk: int, bsz: int, nsb: np.ndarray):
    """Invert `_emit_planes`: (m, neg, the bit offset after the planes).

    A plane's four sections each span all blocks, so the blocks are read
    `EMIT_CHUNK` at a time in four rounds a plane: each round's bit counts
    are known from the state (refinement bits, k fields) or from the round
    before (tested bits from k, signs from the tested bits), and their
    offsets place each chunk's slice of the section."""
    m = np.zeros((nblk, bsz), dtype=np.int64)
    neg = np.zeros((nblk, bsz), dtype=bool)
    w = k_width(bsz)
    kweights = (1 << np.arange(w - 1, -1, -1)).astype(np.int64)
    maxp = int(nsb.max()) if nsb.size else 0
    n = -(-nblk // EMIT_CHUNK)
    state: list = [None] * n

    def offsets(counts: list) -> list:
        nonlocal pos
        at = pos + np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
        pos += int(sum(counts))
        return [int(v) for v in at]

    for p in range(maxp - 1, -1, -1):
        def open_plane(i: int) -> tuple[int, int]:
            lo = i * EMIT_CHUNK
            mc, negc = m[lo : lo + EMIT_CHUNK], neg[lo : lo + EMIT_CHUNK]
            active = nsb[lo : lo + EMIT_CHUNK] > p
            if not active.any():
                state[i] = None
                return 0, 0
            blk = None if active.all() else np.flatnonzero(active)
            ma = mc if blk is None else mc[blk]
            sig_prev = ma > 0  # m currently holds bits above plane p
            ma <<= 1
            rem = ~sig_prev
            has_rem = rem.any(axis=1)
            state[i] = [mc, negc, blk, ma, sig_prev, rem, has_rem]
            return int(sig_prev.sum()), int(has_rem.sum()) * w

        counts = _map_chunks(open_plane, n)
        ref_at = offsets([c[0] for c in counts])
        k_at = offsets([c[1] for c in counts])

        # 1) refinement, 2) k values, and the tested coefficients
        def read_k(i: int) -> int:
            if state[i] is None:
                return 0
            _, _, _, ma, sig_prev, rem, has_rem = state[i]
            nref, nk = counts[i]
            if nref:
                ma[sig_prev] |= bits[ref_at[i] : ref_at[i] + nref]
            k = np.zeros(len(ma), dtype=np.int64)
            if nk:
                k[has_rem] = bits[k_at[i] : k_at[i] + nk].reshape(-1, w) @ kweights
            rank = np.cumsum(rem, axis=1, dtype=np.int8) - 1
            test = rem & (rank < k[:, None])
            state[i].append(test)
            return int(test.sum())

        ntest = _map_chunks(read_k, n)
        test_at = offsets(ntest)

        # 3) significance bits of the first k remaining coefficients
        def read_significance(i: int) -> int:
            if state[i] is None:
                return 0
            ma, rem, test = state[i][3], state[i][5], state[i][7]
            newly = np.zeros_like(rem)
            if ntest[i]:
                bmb = bits[test_at[i] : test_at[i] + ntest[i]]
                ma[test] |= bmb
                newly[test] = bmb.astype(bool)
            state[i].append(newly)
            return int(newly.sum())

        nnew = _map_chunks(read_significance, n)
        sign_at = offsets(nnew)

        # 4) signs
        def read_signs(i: int) -> None:
            if state[i] is None:
                return
            mc, negc, blk, ma = state[i][:4]
            newly = state[i][8]
            na = negc if blk is None else negc[blk]
            if nnew[i]:
                na[newly] = bits[sign_at[i] : sign_at[i] + nnew[i]].astype(bool)
            if blk is not None:
                mc[blk] = ma
                negc[blk] = na

        _map_chunks(read_signs, n)
    return m, neg, pos


def zfp_container(
    shape: tuple[int, ...],
    padded: tuple[int, ...],
    eb: float,
    transform: str,
    e: np.ndarray,
    nsb: np.ndarray,
    nbits: int,
    payload: bytes,
) -> bytes:
    """Assemble the ZFJX container around an already-packed plane payload
    (shared by the host and the device Stage III)."""
    n = len(shape)
    hdr = struct.pack("<4sBdQ", _MAGIC, n, float(eb), len(e)) + struct.pack(
        f"<{n}q{n}q", *shape, *padded
    )
    return b"".join(
        [
            hdr,
            transform.encode().ljust(16, b"\0"),
            np.asarray(e, np.int16).tobytes(),
            np.asarray(nsb, np.uint8).tobytes(),
            struct.pack("<Q", int(nbits)),
            payload,
        ]
    )


def zfp_encode_quantized(
    q: np.ndarray,
    e: np.ndarray,
    shape: tuple[int, ...],
    padded: tuple[int, ...],
    eb: float,
    transform: str = "zfp",
) -> bytes:
    """Stage III on precomputed quantized block coefficients `q`
    ((nblk, 4^n), raw pre-degree-order layout) and exponents `e`."""
    n = len(shape)
    q = np.asarray(q, dtype=np.int64).reshape(len(e), 4**n)
    q = q[:, degree_order(n)]
    m = np.abs(q)
    neg = q < 0
    mx = m.max(axis=1) if m.size else np.zeros(0, dtype=np.int64)
    nsb = np.zeros(len(m), dtype=np.uint8)
    nz = mx > 0
    nsb[nz] = np.floor(np.log2(mx[nz])).astype(np.uint8) + 1
    parts = _emit_planes(m, neg, nsb)
    allbits = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    payload = np.packbits(allbits).tobytes()
    return zfp_container(
        shape, padded, eb, transform, e, nsb, int(allbits.size), payload
    )


def zfp_compress(x: np.ndarray, eb: float, transform: str = "zfp") -> bytes:
    x = np.asarray(x, dtype=np.float32)
    q, e, _, padded, _, _ = _prepare_blocks(x, eb, transform)
    return zfp_encode_quantized(q, e, x.shape, padded, eb, transform)


def zfp_decompress(buf: bytes) -> np.ndarray:
    off = 0
    magic, n, eb, nblk = struct.unpack_from("<4sBdQ", buf, off)
    if magic != _MAGIC:
        raise ValueError(f"not a ZFJX stream (magic {magic!r})")
    off += struct.calcsize("<4sBdQ")
    dims = struct.unpack_from(f"<{n}q{n}q", buf, off)
    off += 16 * n
    shape, padded = tuple(dims[:n]), tuple(dims[n:])
    transform = buf[off : off + 16].rstrip(b"\0").decode()
    off += 16
    e = np.frombuffer(buf[off : off + 2 * nblk], dtype=np.int16)
    off += 2 * nblk
    nsb = np.frombuffer(buf[off : off + nblk], dtype=np.uint8)
    off += nblk
    (nbits,) = struct.unpack_from("<Q", buf, off)
    off += 8
    bits = np.unpackbits(np.frombuffer(buf[off:], dtype=np.uint8))[:nbits]
    bsz = 4**n
    m, neg, _ = _read_planes(bits, 0, nblk, bsz, nsb.astype(np.int64))
    inv = np.argsort(degree_order(n))  # undo the degree-ordered layout
    m = m[:, inv]
    neg = neg[:, inv]
    gain_n = bot_linf_gain(transform) ** n
    raw = eb / (np.exp2(e.astype(np.float64)) * gain_n)
    step = np.exp2(np.floor(np.log2(np.maximum(raw, 2.0**-60))))
    mag = np.where(m > 0, (m.astype(np.float64) + 0.5) * step[:, None], 0.0)
    coeffs = np.where(neg, -mag, mag).reshape((nblk,) + (4,) * n)
    T = bot_matrix(transform)
    rec = coeffs
    for axis in range(1, n + 1):
        rec = np.moveaxis(np.tensordot(rec, T.T, axes=[[axis], [1]]), -1, axis)
    rec = rec * np.exp2(e.astype(np.float64)).reshape((-1,) + (1,) * n)
    out = unblockize(torch.from_numpy(rec.astype(np.float32)), padded, shape)
    return out.numpy().copy()
