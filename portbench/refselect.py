"""The plain reference's Algorithm 1 (paper §5.3): the SZ-or-ZFP decision
and its bounds for one field under a pointwise error bound, in numpy
float64.

Per field: sample 4^n blocks at rate r_sp on the paper's lattice; estimate
ZFP's bit-rate (the exact bit count of the plane-major k-prefix coder on
the sampled blocks) and PSNR (truncation error of a fixed pattern of
points per block) at the user's bound; invert Eq. (10) for the SZ bin size
at ZFP's PSNR (snapped to a 0.05 dB grid), clamp SZ's bound to the user's;
estimate SZ's bit-rate from the entropy of the sampled integer Lorenzo
residuals (Miller-Madow correction, the Chao1 Huffman-table cost, +0.5
bit, 64 bits an escape); pick the smaller rate. It follows the published
description and the stream formats; it imports nothing of the program,
and computes in float64 where the program computes in float32.
"""

from __future__ import annotations

import math

import numpy as np

from .refcodec import bot_linf_gain, bot_matrix, degree_order, k_width

R_SP = 0.05
PDF_BINS = 65535
SZ_BITRATE_OFFSET = 0.5
PSNR_MATCH_QUANTUM = 0.05
BLOCK_HEADER_BITS = 24
MAX_PLANES = 31


def table_bits_per_symbol() -> float:
    """The serialised Huffman table's cost a symbol: ~5 bits when the table
    is zstd-compressed (the stream format's choice when `zstandard` is
    importable), 40 bits (4-byte delta + 1-byte length) when it is not."""
    try:
        import zstandard  # noqa: F401

        return 5.0
    except ImportError:
        return 40.0


def _split_strides(target: int, nd: int) -> tuple[int, ...]:
    strides = []
    rem = max(target, 1)
    for i in range(nd - 1, 0, -1):
        f = max(1, int(round(rem ** (1.0 / (i + 1)))))
        if strides and f == strides[-1] and f > 1:
            f -= 1
        strides.append(f)
        rem = max(1, int(round(rem / f)))
    strides.append(max(rem, 1))
    return tuple(strides)


def block_starts(shape: tuple[int, ...], r_sp: float = R_SP) -> np.ndarray:
    """(n_s, nd) origins of the sampled blocks: per-dimension block strides
    whose product is 1/r_sp, fixed within a dimension and different
    across dimensions (paper §4.3)."""
    nd = len(shape)
    strides = _split_strides(int(round(1.0 / r_sp)), nd)
    axes = [np.arange(0, max(d // 4, 1), s, dtype=np.int64) * 4 for d, s in zip(shape, strides)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def gather_blocks(x: np.ndarray, starts: np.ndarray, halo: bool) -> np.ndarray:
    """(n_s, w, ..) float64 blocks at `starts`; with `halo` a leading row of
    original neighbours on every axis, zero outside the domain."""
    nd = x.ndim
    lo = -1 if halo else 0
    offs = np.arange(lo, 4)
    w = 4 - lo
    idx, mask = [], np.ones((len(starts),) + (w,) * nd, dtype=bool)
    for d in range(nd):
        i = starts[:, d][:, None] + offs[None, :]
        sh = [len(starts)] + [1] * nd
        sh[1 + d] = w
        mask = mask & (i >= 0).reshape(sh)
        idx.append(np.clip(i, 0, x.shape[d] - 1).reshape(sh))
    return np.where(mask, x[tuple(idx)].astype(np.float64), 0.0)


def _coder_bits(m: np.ndarray, nd: int) -> np.ndarray:
    """Exact bits a block of the plane-major k-prefix coder takes: per plane
    from the block's top one down, refinement bits, a k field where
    coefficients remain insignificant, k significance tests and a sign a
    newly significant coefficient; plus the block header."""
    bsz = 4**nd
    w = k_width(bsz)
    m = m[:, degree_order(nd)]
    mx = m.max(axis=1)
    nsb = np.where(mx > 0, np.floor(np.log2(np.maximum(mx, 1))) + 1, 0).astype(np.int64)
    total = np.zeros(len(m), dtype=np.int64)
    for p in range(MAX_PLANES):
        active = nsb > p
        if not active.any():
            break
        sig_prev = ((m >> (p + 1)) > 0) & active[:, None]
        rem = active[:, None] & ~sig_prev
        has_rem = rem.any(axis=1)
        rank = np.cumsum(rem, axis=1) - 1
        newly = rem & (((m >> p) & 1) == 1)
        k = np.max(np.where(newly, rank + 1, 0), axis=1)
        total += sig_prev.sum(axis=1) + w * has_rem + k + newly.sum(axis=1)
    return total + BLOCK_HEADER_BITS


def _ec_points(nd: int) -> np.ndarray:
    m = np.zeros((4,) * nd, dtype=bool)
    if nd == 1:
        m[np.array([0, 1, 3])] = True
    elif nd == 2:
        for i in (0, 1, 3):
            for j in (0, 2, 3):
                m[i, j] = True
    else:
        m[np.ix_((0, 2), (1, 3), (0, 1, 2, 3))] = True
    return np.flatnonzero(m.reshape(-1))


def estimate_zfp(blocks: np.ndarray, eb: float, vr: float) -> tuple[float, float]:
    """(bit-rate, PSNR) of ZFP at bound `eb` on the sampled blocks."""
    nd = blocks.ndim - 1
    n_s = len(blocks)
    mx = np.maximum(np.abs(blocks).reshape(n_s, -1).max(axis=1), 1e-30)
    e = np.ceil(np.log2(mx))
    coeffs = blocks * np.exp2(-e).reshape((-1,) + (1,) * nd)
    T = bot_matrix("zfp")
    for axis in range(1, nd + 1):
        coeffs = np.moveaxis(np.tensordot(coeffs, T, axes=[[axis], [1]]), -1, axis)
    coeffs = coeffs.reshape(n_s, -1)
    raw = eb / (np.exp2(e) * bot_linf_gain("zfp") ** nd)
    step = np.exp2(np.floor(np.log2(np.maximum(raw, 2.0**-60))))
    m = np.minimum(np.trunc(np.abs(coeffs) / step[:, None]), 2.0**31 - 1).astype(np.int64)
    bitrate = float(_coder_bits(m, nd).sum()) / (n_s * 4**nd)
    co = coeffs[:, _ec_points(nd)]
    mt = np.trunc(np.abs(co) / step[:, None])
    rec = np.sign(co) * np.where(mt > 0, (mt + 0.5) * step[:, None], 0.0)
    err = (co - rec) * np.exp2(e)[:, None]
    mse = float(np.mean(err * err))
    psnr = -10.0 * math.log10(max(mse, 1e-300)) + 20.0 * math.log10(max(vr, 1e-30))
    return bitrate, psnr


def sz_delta_for_psnr(psnr: float, vr: float) -> float:
    """Eq. (10) inverted: the SZ bin size whose uniform error gives `psnr`
    (snapped to the 0.05 dB grid)."""
    psnr_q = round(psnr / PSNR_MATCH_QUANTUM) * PSNR_MATCH_QUANTUM
    return vr * math.sqrt(12.0) * 10.0 ** (-psnr_q / 20.0)


def estimate_sz(halo_blocks: np.ndarray, delta: float, size: int) -> float:
    """Eq. (9) bit-rate of SZ at bin size `delta` from the sampled blocks'
    integer Lorenzo residuals."""
    nd = halo_blocks.ndim - 1
    d = np.round(halo_blocks / delta)
    for ax in range(1, nd + 1):
        d = np.diff(d, axis=ax)
    k = d.reshape(-1)
    half = (PDF_BINS - 1) // 2
    ofrac = float(np.mean(np.abs(k) > half))
    hist = np.bincount((np.clip(k, -half, half) + half).astype(np.int64), minlength=PDF_BINS)
    n = max(int(hist.sum()), 1)
    p = hist[hist > 0] / n
    ent = float(-(p * np.log2(p)).sum())
    n_obs = float(len(p))
    ent += (n_obs - 1.0) / (2.0 * n * math.log(2.0))
    f1 = float((hist == 1).sum())
    f2 = float((hist == 2).sum())
    chao1 = n_obs + f1 * max(f1 - 1.0, 0.0) / (2.0 * (f2 + 1.0))
    table_bits = table_bits_per_symbol() * min(chao1, float(PDF_BINS))
    return ent + SZ_BITRATE_OFFSET + ofrac * 64.0 + table_bits / max(size, 1)


def decide(x: np.ndarray, eb_rel: float, r_sp: float = R_SP) -> dict:
    """Algorithm 1 on a 2-D or 3-D float32 field at bound eb_rel x range."""
    vr = float(np.float64(x.max()) - np.float64(x.min()))
    eb = eb_rel * vr
    starts = block_starts(x.shape, r_sp)
    halo = gather_blocks(x, starts, halo=True)
    nohalo = halo[(slice(None),) + (slice(1, None),) * x.ndim]
    br_zfp, psnr_zfp = estimate_zfp(nohalo, eb, vr)
    eb_sz = min(max(sz_delta_for_psnr(psnr_zfp, vr) / 2.0, eb * 1e-6), eb)
    br_sz = estimate_sz(halo, 2.0 * eb_sz, x.size)
    codec = "sz" if br_sz < br_zfp else "zfp"
    if min(br_sz, br_zfp) >= 32.0:
        codec = "raw"
    return dict(codec=codec, eb_abs=eb, eb_sz=eb_sz, br_sz=br_sz, br_zfp=br_zfp, vr=vr)
