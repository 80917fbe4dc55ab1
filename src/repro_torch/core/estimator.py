"""Online compression-quality estimation (paper §4.3, §5 — Steps 1 & 2),
in torch.

Port of `repro.core.estimator`: the single-field estimates and the
batched ones over packed multi-field block batches (`field_sums`,
`estimate_zfp_many`, `estimate_sz_many`). From a small blockwise sample (default r_sp = 5%) of a field:

* SZ: PSNR in closed form from the bin size (Eq. (11)); bit-rate from the
  entropy of the sampled integer Lorenzo residuals (Eq. (9)) with the
  Miller-Madow correction, the Chao1 Huffman-table cost and the +0.5
  offset.
* ZFP: bit-rate from the exact coder bit count of the sampled blocks; PSNR
  from the truncation error of a fixed pattern of sampled points.

Everything runs on the field's device in float32, as the reference runs
with JAX's x64 mode off.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import to_int_saturating
from .embedded import (
    BLOCK_HEADER_BITS,
    align_blocks,
    block_bits,
    exact_coder_bits,
    exact_coder_bits_blocks,
    k_width,
    plane_step,
    significant_bits,
)
from .transforms import block_transform_nd, bot_linf_gain, bot_matrix
from .xla_f32 import _exp2, _round32, _xla_log, _xla_log2

DEFAULT_SAMPLING_RATE = 0.05  # paper default
PDF_BINS = 65535  # paper §6.3.2
SZ_BITRATE_OFFSET = 0.5  # paper §6.2


def _table_bits_per_symbol() -> float:
    """Serialized Huffman-table cost per symbol, matching what `entropy.py`
    emits in this environment: ~5 bits with the zstd'd delta+length
    serialization, 40 bits (4-byte symbol delta + 1-byte code length) when
    `zstandard` is absent and the table ships as the raw blob.

    `REPRO_SZ_TABLE_BITS` overrides the probe (a test hook shared with the
    reference, so both read the same value in one environment)."""
    override = os.environ.get("REPRO_SZ_TABLE_BITS")
    if override:
        return float(override)
    try:
        import zstandard  # noqa: F401

        return 5.0
    except ImportError:
        return 40.0


TABLE_BITS_PER_SYMBOL = _table_bits_per_symbol()
LN2 = math.log(2.0)
LN10 = math.log(10.0)


# ---------------------------------------------------------------------------
# Step 1 — blockwise sampling
# ---------------------------------------------------------------------------


def _split_strides(target: int, nd: int) -> tuple[int, ...]:
    """Split 1/r_sp into nd per-dimension block strides, 'fixed in the same
    dimension and different across dimensions' (paper §4.3)."""
    strides = []
    rem = max(target, 1)
    for i in range(nd - 1, 0, -1):
        f = max(1, int(round(rem ** (1.0 / (i + 1)))))
        # nudge successive dims apart so sample lattices don't alias
        if strides and f == strides[-1] and f > 1:
            f -= 1
        strides.append(f)
        rem = max(1, int(round(rem / f)))
    strides.append(max(rem, 1))
    return tuple(strides)


def block_starts(shape: tuple[int, ...], r_sp: float) -> np.ndarray:
    """(n_s, nd) int array of sampled 4^n block origins (host-side)."""
    nd = len(shape)
    strides = _split_strides(int(round(1.0 / max(r_sp, 1e-6))), nd)
    axes = []
    for d, s in zip(shape, strides):
        nb = max(d // 4, 1)
        axes.append(np.arange(0, nb, s, dtype=np.int64) * 4)
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def gather_blocks(x: torch.Tensor, starts: np.ndarray, halo: bool = False) -> torch.Tensor:
    """Sampled blocks (n_s, 4, ..) of `x` on its device — or (n_s, 5, ..)
    with a leading halo of original neighbours, zero outside the domain
    (the boundary convention of `lorenzo_forward`)."""
    nd = x.ndim
    lo = -1 if halo else 0
    offs = torch.arange(lo, 4, device=x.device)
    st = torch.as_tensor(np.asarray(starts, dtype=np.int64), device=x.device)
    ns = st.shape[0]
    w = 4 - lo
    bidx, masks = [], []
    for d in range(nd):
        i = st[:, d][:, None] + offs[None, :]
        sh = [ns] + [1] * nd
        sh[1 + d] = w
        masks.append((i >= 0).reshape(sh))
        bidx.append(torch.clamp(i, 0, x.shape[d] - 1).reshape(sh))
    out = x[tuple(bidx)]
    if halo:
        for m in masks:
            out = out * m.to(out.dtype)
    return out


def gather_blocks_np(x: np.ndarray, starts: np.ndarray, halo: bool = False) -> np.ndarray:
    """Host twin of `gather_blocks` (same implementation, on the CPU)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return gather_blocks(t, starts, halo).numpy()


def lorenzo_residual_samples(
    x: torch.Tensor, starts: np.ndarray, delta: torch.Tensor | float | None = None
) -> torch.Tensor:
    """Prediction errors of the sampled points from original neighbours
    (§4.3). With `delta`, values are prequantized to integer codes first,
    matching the integer-Lorenzo codec. Returns (n_s * 4^nd,) residuals."""
    nd = x.ndim
    d = gather_blocks(x, starts, halo=True)
    if delta is not None:
        d = torch.round(d / torch.as_tensor(delta, dtype=d.dtype, device=d.device))
    for ax in range(1, nd + 1):
        n = d.shape[ax]
        d = d.narrow(ax, 1, n - 1) - d.narrow(ax, 0, n - 1)
    return d.reshape(-1)


# ---------------------------------------------------------------------------
# Step 2 — SZ estimation
# ---------------------------------------------------------------------------


@dataclass
class Estimate:
    bitrate: torch.Tensor | None  # None from estimate_zfp_many(mode="psnr")
    psnr: torch.Tensor | None     # None from estimate_zfp_many(psnr=False)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def sz_psnr(eb, vr) -> torch.Tensor:
    """Eq. (11): PSNR_sz = -20 log10(eb/VR) + 10 log10(3)."""
    eb = torch.as_tensor(eb, dtype=torch.float32)
    eb_rel = eb / _f32(vr, eb.device)
    return -20.0 * torch.log10(torch.clamp_min(eb_rel, 1e-30)) + 10.0 * math.log10(3.0)


#: the iso-PSNR match point is snapped to this grid (dB) before inverting
#: Eq. (10), so a 1-ulp PSNR difference cannot move the derived bin size
PSNR_MATCH_QUANTUM = 0.05


#: glibc's `powf` (the float32 `pow` XLA's CPU backend calls) computes
#: x^y as 2^(y * log2 x) in double: log2 x from a 16-entry table and a
#: degree-5 polynomial, 2^t from 2^(i/32) and a cubic, then one rounding to
#: float32. `_pow10_f32` takes the same steps for x = 10. This is the
#: double its log2 step gives for 10 (about 3.8e3 ulps above log2(10)).
_POWF_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
#: its 2^r polynomial on r in [-1/64, 1/64], highest power first
_POWF_EXP2_POLY = tuple(
    float.fromhex(h)
    for h in ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")
)
#: adding and subtracting 1.5 * 2^47 rounds a double to a multiple of 1/32
_POWF_SHIFT = float.fromhex("0x1.8p+47")


def _exp2_table() -> torch.Tensor:
    """2^(i/32), i < 32, each correctly rounded to double (glibc's table)."""
    from decimal import Decimal, localcontext

    with localcontext() as ctx:
        ctx.prec = 40
        vals = [float(Decimal(2) ** (Decimal(i) / 32)) for i in range(32)]
    return torch.tensor(vals, dtype=torch.float64)


_EXP2_TABLE = _exp2_table()


def _pow10_f32(y: torch.Tensor) -> torch.Tensor:
    """float32 10^y bit for bit as the reference computes `10.0 ** y` on the
    CPU, compiled or eager: glibc's `powf`, which is not correctly rounded
    (at y = -4.07, -4.9875 and -6.555 it is one ulp above the float32
    nearest 10^y). Only IEEE double adds and multiplies, so the card gives
    the same bits."""
    xd = y.to(torch.float64) * _POWF_LOG2_10
    bad = ~torch.isfinite(xd)
    xs = torch.where(bad, 0.0, xd).clamp(-400.0, 400.0)
    kd = (xs + _POWF_SHIFT) - _POWF_SHIFT  # k/32, the nearest multiple
    r = xs - kd
    k = torch.round(kd * 32.0).to(torch.int64)
    i = torch.remainder(k, 32)
    e = torch.div(k - i, 32, rounding_mode="floor").to(torch.float64)
    s = _EXP2_TABLE.to(xd.device)[i] * torch.pow(2.0, e)
    c0, c1, c2 = _POWF_EXP2_POLY
    z = c0 * r + c1
    p = c2 * r + 1.0
    p = z * (r * r) + p
    out = (p * s).to(torch.float32)
    # XLA runs with subnormals flushed to zero
    out = torch.where(out < torch.finfo(torch.float32).tiny, 0.0, out)
    # 10^inf = inf, 10^-inf = 0, NaN stays NaN
    return torch.where(bad, torch.exp2(xd.to(torch.float32)), out)


def sz_delta_for_psnr(psnr: torch.Tensor, vr, *, eager: bool = False) -> torch.Tensor:
    """Invert Eq. (10): delta = VR * sqrt(12) * 10^(-PSNR/20), with PSNR
    snapped to the PSNR_MATCH_QUANTUM grid, in float32 bit for bit with the
    reference's `sz_delta_for_psnr`.

    The default follows its compiled program (inside `select` and
    `select_many`), where XLA turns each division by a constant into a
    multiplication by the reciprocal: PSNR * 20, and -psnr_q * 0.05.
    `eager=True` follows the same function run outside jit, op by op (the
    controller's seed), where both are true divisions. A few ulps in delta
    move round(x / delta) at .5 ties, which the Chao1 table cost amplifies.
    """
    psnr = torch.as_tensor(psnr, dtype=torch.float32)
    if eager:
        psnr_q = torch.round(psnr / PSNR_MATCH_QUANTUM) * PSNR_MATCH_QUANTUM
        y = -psnr_q / 20.0
    else:
        psnr_q = torch.round(psnr * 20.0) * PSNR_MATCH_QUANTUM
        y = -psnr_q * 0.05
    return _f32(vr, psnr.device) * math.sqrt(12.0) * _pow10_f32(y)


def sz_bitrate_from_hist(
    hist: torch.Tensor, ofrac: torch.Tensor, size, n_pdf: int = PDF_BINS
) -> torch.Tensor:
    """Eq. (9) bit-rate from a dense residual-bin-count histogram: sample
    entropy with the Miller-Madow correction, the Chao1 Huffman-table cost
    (priced at TABLE_BITS_PER_SYMBOL, amortized over the full field), the
    +0.5 offset and the 64-bit escape payload."""
    n_samp = torch.clamp_min(hist.sum(), 1).to(torch.float32)
    p = hist.to(torch.float32) / n_samp
    plogp = p * torch.log2(torch.clamp_min(p, 1e-30))
    ent = -torch.sum(torch.where(p > 0, plogp, torch.zeros_like(p)))
    n_obs = torch.sum((hist > 0).to(torch.float32))
    ent = ent + (n_obs - 1.0) / (2.0 * n_samp * LN2)
    f1 = torch.sum((hist == 1).to(torch.float32))
    f2 = torch.sum((hist == 2).to(torch.float32))
    chao1 = n_obs + f1 * torch.clamp_min(f1 - 1.0, 0.0) / (2.0 * (f2 + 1.0))
    table_bits = TABLE_BITS_PER_SYMBOL * torch.clamp_max(chao1, float(n_pdf))
    size = torch.clamp_min(_f32(size, hist.device), 1.0)
    return ent + SZ_BITRATE_OFFSET + ofrac * 64.0 + table_bits / size


def estimate_sz(
    x: torch.Tensor,
    delta,
    starts: np.ndarray,
    vr,
    n_pdf: int = PDF_BINS,
    mode: str = "integer",
) -> Estimate:
    """Eq. (9) entropy bit-rate (+0.5 offset) and Eq. (11) PSNR.

    mode='integer' — PDF of integer-code residuals (the codec's, default);
    mode='paper'   — PDF of float Lorenzo residuals binned by delta (§5.1).
    """
    delta = _f32(delta, x.device)
    half = (n_pdf - 1) // 2
    if mode == "integer":
        k_raw = lorenzo_residual_samples(x, starts, delta=delta)
    else:
        k_raw = torch.round(lorenzo_residual_samples(x, starts) / delta)
    ofrac = torch.mean((k_raw.abs() > half).to(torch.float32))  # escapes
    k = torch.clamp(k_raw, -half, half)
    hist = torch.bincount((k + half).to(torch.int64), minlength=n_pdf)
    br = sz_bitrate_from_hist(hist, ofrac, x.numel(), n_pdf)
    return Estimate(bitrate=br, psnr=sz_psnr(delta / 2.0, vr))


# ---------------------------------------------------------------------------
# Step 2 — ZFP estimation
# ---------------------------------------------------------------------------


#: -10 log10(x) = log(x) * this, the two constants folded as XLA folds
#: them: f32(-10 * f32(1 / ln 10))
_NEG10_OVER_LN10 = float(np.float32(-10.0) * np.float32(1.0 / LN10))


def _neg10_log10(x: torch.Tensor) -> torch.Tensor:
    """`-10 * log10(max(x, 1e-60))` as the reference's compiled estimators
    evaluate it (1e-60 is 0 in float32; the two constants fold into one)."""
    return _xla_log(torch.clamp_min(x, 0.0)) * _NEG10_OVER_LN10


def _ec_point_mask(nd: int) -> np.ndarray:
    """Fixed point pattern inside a 4^nd block (3/9/16 pts for 1/2/3-D)."""
    m = np.zeros((4,) * nd, dtype=bool)
    if nd == 1:
        m[np.array([0, 1, 3])] = True
    elif nd == 2:
        for i in (0, 1, 3):
            for j in (0, 2, 3):
                m[i, j] = True
    else:
        m[np.ix_((0, 2), (1, 3), (0, 1, 2, 3))] = True
    return m


def estimate_zfp(
    x: torch.Tensor,
    eb,
    starts: np.ndarray,
    vr,
    transform: str = "zfp",
    mode: str = "exact",
) -> Estimate:
    """ZFP quality estimate from sampled blocks.

    mode='exact' — the exact coder bit count of the sampled blocks (default);
    mode='paper' — mean n_sb of the sampled points plus coder overhead.
    PSNR is the sampled truncation error (§5.2.2) in both modes.
    """
    nd = x.ndim
    dev = x.device
    blocks = gather_blocks(x, starts, halo=False).to(torch.float32)
    n_s = blocks.shape[0]
    norm, e = align_blocks(blocks)
    coeffs = block_transform_nd(norm, bot_matrix(transform), nd)
    gain_n = bot_linf_gain(transform) ** nd
    step = plane_step(_f32(eb, dev), e, gain_n)
    sel = torch.as_tensor(np.flatnonzero(_ec_point_mask(nd).reshape(-1)), device=dev)
    bsz = 4**nd
    if mode == "exact":
        bitrate = exact_coder_bits(coeffs, step) / (n_s * bsz)
    else:
        samp_nsb = significant_bits(coeffs, step).reshape(n_s, -1)[:, sel]
        nbar = torch.mean(samp_nsb)
        max_planes = torch.mean(torch.amax(samp_nsb, dim=1))
        sig_frac = torch.mean((samp_nsb > 0).to(torch.float32))
        w = k_width(bsz)
        overhead = (BLOCK_HEADER_BITS + w * max_planes) / bsz + 2.0 * sig_frac
        bitrate = nbar + overhead
    # PSNR: truncation error of the sampled points, de-normalized
    s = step.reshape(-1, 1).to(torch.float32)
    co = coeffs.reshape(n_s, -1)[:, sel]
    m = torch.trunc(co.abs() / s)
    rec = torch.sign(co) * torch.where(m > 0, (m + 0.5) * s, torch.zeros_like(m))
    scale = _exp2(e).reshape(-1, 1)
    err = (co - rec) * scale
    mse_sp = torch.mean(torch.square(err))
    vr32 = torch.clamp_min(_f32(vr, dev), 1e-30)
    psnr = -10.0 * torch.log10(torch.clamp_min(mse_sp, 1e-60)) + 20.0 * torch.log10(vr32)
    return Estimate(bitrate=bitrate, psnr=psnr)


# ---------------------------------------------------------------------------
# Batched multi-field estimation
#
# Sampled blocks of many fields are packed along one leading axis in field
# order: blocks [bounds[f], bounds[f+1]) belong to field f. Every per-field
# quantity is a prefix sum and two boundary gathers.
# ---------------------------------------------------------------------------


#: block length of the reference's float prefix sums: XLA's CPU compiler
#: rewrites `jnp.cumsum` into sequential sums over blocks of 16 values, a
#: prefix sum of the block totals (the same way, recursively), and one add
#: of each block's carry; `_cumsum_blocked` takes the same steps
_SCAN_BLOCK = 16


def _cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0 in the reference's float order
    (bit for bit with `jnp.cumsum` on the CPU): elementwise adds only, so
    the card gives the same bits as the host."""
    n, rest = x.shape[0], tuple(x.shape[1:])
    pad = (-n) % _SCAN_BLOCK
    xp = torch.cat([x, x.new_zeros((pad,) + rest)]).reshape((-1, _SCAN_BLOCK) + rest)
    cols = [xp[:, 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + xp[:, j])
    loc = torch.stack(cols, dim=1)
    if loc.shape[0] > 1:
        inc = _cumsum_blocked(loc[:, -1])
        carry = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
        loc = loc + carry.reshape((-1, 1) + rest)
    return loc.reshape((-1,) + rest)[:n]


def field_sums(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Per-field sums of field-ordered rows: x is (S,) or (S, C) with rows
    [bounds[f], bounds[f+1]) belonging to field f; returns (F,) / (F, C).

    The window is a difference of two global prefix sums, taken in `x`'s
    own dtype: integer columns accumulate exactly in int32 (torch would
    otherwise widen to int64); float columns in the reference's order
    (`_cumsum_blocked`), and should be normalized per field first so the
    small fields do not cancel away."""
    if x.dtype.is_floating_point:
        cs = _cumsum_blocked(x)
    else:
        # columns scanned along their innermost dim: the card's scan along
        # an outer dim of a tall (S, 3) tensor is a serial walk per column
        # (~1 s at 16.8M rows on an H100)
        cs = torch.cumsum(x.movedim(0, -1).contiguous(), dim=-1, dtype=x.dtype).movedim(-1, 0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    bounds = bounds.to(device=x.device, dtype=torch.int64)
    return cs[bounds[1:]] - cs[bounds[:-1]]


def _point_energy(err: torch.Tensor) -> torch.Tensor:
    """Per-block sum of squares of the (n, k) sampled-point errors in the
    order and roundings of the reference's compiled reduction on the CPU:
    the 3 or 9 points of a 1-D or 2-D block one after another with FMAs;
    the 16 of a 3-D block as 8 lanes, point i + 8 squared onto point i's
    square with an FMA, then the lanes halved pairwise (i + 4, i + 2,
    i + 1)."""
    e = err.double()
    if e.shape[1] != 16:
        s = torch.zeros_like(e[:, 0])
        for j in range(e.shape[1]):
            s = _round32(torch.addcmul(s, e[:, j], e[:, j]))
        return s.float()
    lo, hi = e[:, :8], e[:, 8:]
    lanes = torch.addcmul(_round32(lo * lo), hi, hi).float()
    lanes = lanes[:, :4] + lanes[:, 4:]
    lanes = lanes[:, :2] + lanes[:, 2:]
    return lanes[:, 0] + lanes[:, 1]


def estimate_zfp_many(
    blocks: torch.Tensor,
    seg: torch.Tensor,
    bounds: torch.Tensor,
    eb_f: torch.Tensor,
    vr_f: torch.Tensor,
    transform: str = "zfp",
    mode: str = "exact",
    *,
    psnr: bool = True,
) -> Estimate:
    """`estimate_zfp` for a packed batch of blocks from many fields.
    `blocks` is (total_blocks, 4, ..) in field order, seg[i] = field of
    block i, bounds the (n_fields+1,) block boundary array; returns
    per-field Estimate tensors of shape (n_fields,).

    mode='exact' — the exact coder bit counter (31-plane loop);
    mode='model' — the closed-form `block_bits` coder model (one pass);
    mode='psnr'  — no bit count at all (`bitrate` is None), for the
    controller's PSNR-only sweeps: the reference's compiled sweep drops
    the unused coder as dead code, but an eager one would still run it.
    The PSNR is the same in every mode, and bit for bit the reference's
    (its log and its block sums' order, `_point_energy`). Per-block work
    equals the single-field path's; only the final means become
    boundary-windowed prefix sums (bits in int32, the error energy
    normalized by each field's vr^2 before its prefix sum).

    `psnr=False` skips the PSNR (`psnr` is None) for callers that read only
    the rate (the KV tier's budget grid, the controller's rate probes).
    """
    if mode == "psnr" and not psnr:
        raise ValueError("estimate_zfp_many(mode='psnr', psnr=False) estimates nothing")
    nd = blocks.ndim - 1
    bsz = 4**nd
    dev = blocks.device
    blocks = blocks.to(torch.float32)
    seg = seg.to(device=dev, dtype=torch.int64)
    bounds = bounds.to(device=dev, dtype=torch.int64)
    n_s = blocks.shape[0]
    norm, e = align_blocks(blocks)
    coeffs = block_transform_nd(norm, bot_matrix(transform), nd)
    gain_n = bot_linf_gain(transform) ** nd
    step = plane_step(eb_f.to(device=dev, dtype=torch.float32)[seg], e, gain_n)
    if mode == "exact":
        bits_blk = exact_coder_bits_blocks(coeffs, step)  # integer-valued
    elif mode == "model":
        bits_blk = block_bits(coeffs, step)  # integer-valued
    elif mode == "psnr":
        bits_blk = None
    else:
        raise ValueError(f"unknown estimate_zfp_many mode {mode!r}")
    nblk_f = (bounds[1:] - bounds[:-1]).to(torch.float32)
    bitrate = None
    if bits_blk is not None:
        bits_f = field_sums(bits_blk.to(torch.int32), bounds).to(torch.float32)
        bitrate = bits_f / torch.clamp_min(nblk_f * bsz, 1.0)
    if not psnr:
        return Estimate(bitrate=bitrate, psnr=None)
    # PSNR from the EC sample points, as in estimate_zfp
    sel = torch.as_tensor(np.flatnonzero(_ec_point_mask(nd).reshape(-1)), device=dev)
    s = step.reshape(-1, 1).to(torch.float32)
    co = coeffs.reshape(n_s, -1)[:, sel]
    m = torch.trunc(co.abs() / s)
    rec = torch.sign(co) * torch.where(m > 0, (m + 0.5) * s, torch.zeros_like(m))
    scale = _exp2(e).reshape(-1, 1)
    vr32 = torch.clamp_min(vr_f.to(device=dev, dtype=torch.float32), 1e-30)
    err2n_blk = _point_energy((co - rec) * scale) / torch.square(vr32[seg])
    err2n_f = field_sums(err2n_blk, bounds)
    mse_over_vr2 = err2n_f / torch.clamp_min(nblk_f * len(sel), 1.0)
    return Estimate(bitrate=bitrate, psnr=_neg10_log10(mse_over_vr2))


def estimate_sz_many(
    halo_blocks: torch.Tensor,
    seg: torch.Tensor,
    bounds: torch.Tensor,
    delta_f: torch.Tensor,
    vr_f: torch.Tensor,
    size_f: torch.Tensor,
    n_pdf: int = PDF_BINS,
) -> Estimate:
    """`estimate_sz(mode='integer')` for a packed batch of halo blocks.

    `halo_blocks` is (total_blocks, 5, ..): field-ordered sampled blocks
    with the leading original-neighbour halo (zero outside the domain);
    `bounds` is the (n_fields+1,) block boundary array.

    The per-field residual PDFs are never materialized as an
    (n_fields, n_pdf) histogram: samples are sorted once by the int32 key
    (field, bin) = seg * (n_pdf + 1) + bin — fields stay contiguous, so the
    boundaries stay valid — and entropy and the Chao1 table cost come from
    run lengths (run ends from a reverse cumulative min). Count columns
    accumulate exactly in int32; the |p log2 p| terms ride a float32 prefix
    sum, as in the reference (its window moves at the ulp level with the
    batch's composition and the scan's order).
    """
    nd = halo_blocks.ndim - 1
    dev = halo_blocks.device
    seg = seg.to(device=dev, dtype=torch.int32)
    bounds = bounds.to(device=dev, dtype=torch.int32)
    delta_f = delta_f.to(device=dev, dtype=torch.float32)
    half = (n_pdf - 1) // 2
    idx = seg.to(torch.int64)
    d = torch.round(halo_blocks.to(torch.float32) / delta_f[idx].reshape((-1,) + (1,) * nd))
    for ax in range(1, nd + 1):
        n = d.shape[ax]
        d = d.narrow(ax, 1, n - 1) - d.narrow(ax, 0, n - 1)
    bsz = 4**nd
    k_raw = d.reshape(-1)  # (total_blocks * 4^nd,)
    n_samples = k_raw.shape[0]
    sbounds = bounds * bsz  # sample-level field boundaries
    n_samp_f = (sbounds[1:] - sbounds[:-1]).to(torch.float32)
    # escape fraction from the field-ordered samples (exact int32 counts)
    esc = (k_raw.abs() > half).to(torch.int32)
    ofrac = field_sums(esc, sbounds).to(torch.float32) / torch.clamp_min(n_samp_f, 1.0)
    k = torch.clamp(k_raw, -half, half)
    # (field, bin) sort: seg is nondecreasing, so only bins reorder within
    # each field; the bin's cast saturates as XLA's does (NaN -> bin 0)
    key = torch.repeat_interleave(seg, bsz) * (n_pdf + 1) + to_int_saturating(k + half)
    key = torch.sort(key).values
    pos = torch.arange(n_samples, dtype=torch.int32, device=dev)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), key[1:] != key[:-1]])
    # next run start after each position, via a reverse cumulative min
    fpos = torch.where(first, pos, n_samples)
    nxt_incl = torch.flip(torch.cummin(torch.flip(fpos, (0,)), 0).values, (0,))
    nxt = torch.cat([nxt_incl[1:], torch.full((1,), n_samples, dtype=torch.int32, device=dev)])
    counts = (nxt - pos).to(torch.float32)  # run length, valid at run starts
    fid = (key // (n_pdf + 1)).to(torch.int64)
    p = counts / torch.clamp_min(n_samp_f[fid], 1.0)
    # per-run PDF mass terms: |p log2 p| <= ~0.53, so the f32 prefix sum
    # stays accurate
    plogp = torch.where(first, p * _xla_log2(torch.clamp_min(p, 1e-30)), 0.0)
    firsti = first.to(torch.int32)
    icols = torch.stack(
        [
            firsti,                                        # n_obs
            firsti * (counts == 1.0).to(torch.int32),      # Chao1 singletons
            firsti * (counts == 2.0).to(torch.int32),      # Chao1 doubletons
        ],
        dim=1,
    )
    ent = -field_sums(plogp, sbounds)
    isums = field_sums(icols, sbounds).to(torch.float32)  # (F, 3)
    n_obs, f1, f2 = isums[:, 0], isums[:, 1], isums[:, 2]
    # Miller-Madow plug-in-bias correction, as in `estimate_sz`
    ent = ent + (n_obs - 1.0) / (2.0 * torch.clamp_min(n_samp_f, 1.0) * LN2)
    chao1 = n_obs + f1 * torch.clamp_min(f1 - 1.0, 0.0) / (2.0 * (f2 + 1.0))
    table_bits = TABLE_BITS_PER_SYMBOL * torch.clamp_max(chao1, float(n_pdf))
    size_f = size_f.to(device=dev, dtype=torch.float32)
    br = ent + SZ_BITRATE_OFFSET + ofrac * 64.0 + table_bits / torch.clamp_min(size_f, 1.0)
    return Estimate(bitrate=br, psnr=sz_psnr(delta_f / 2.0, vr_f))
