"""Device-resident Stage III: bitstream encode on the device.

Port of `repro.core.device_encode`. Both encoders emit into the
`kernels/pack.py` word arena, so the only transfers per field are the
packed words and the small per-block side arrays the containers carry.

* **SZ** — two-pass device Huffman: pass 1 is quantize + Lorenzo (the CUDA
  kernels K1/K2 for 2-D/3-D fields, through `kernels.ops.lorenzo_encode`)
  and a 65536-bin histogram; the host builds the canonical code table from
  the histogram and knows the exact payload size; pass 2 looks up codes
  and lengths, takes the exclusive prefix sum of the lengths and packs
  with `pack_codes_gather`. Escape literals are compacted by rank. The
  stream is the SZJ1 layout under the ``SZJ2`` magic.
* **ZFP** — blockize/align/transform on the device, plane magnitudes in
  degree order, and the plane-sectioned k-prefix layout of `zfp.py` in
  closed form: each (plane, block) emits seven right-aligned chunks of at
  most 32 bits (refinement lo/hi, the k field, test lo/hi, sign lo/hi)
  whose values come from masked shift-sums and whose offsets from one
  prefix sum, merged by `pack_codes` into an arena sized by the
  closed-form `block_bits` model. The container is the unchanged ZFJX.

Fed the same quantized codes, these encoders and the host Stage III give
byte-identical streams (`sz_device_residuals` / `zfp_device_codes` expose
the device's codes for exactly that check). The device path quantizes in
float32, like the reference's in-graph path.

Fallback rules — None from an encoder means "use the host coder", never a
truncated stream, and every decline is counted in `DECLINES` by reason:

* the rate model under-estimated and the emitted bits overran the arena;
* code magnitudes beyond float32-exact integer range (2^23 for SZ codes,
  2^24 for ZFP plane magnitudes);
* non-finite values, zero-size fields, or streams past int32 bit offsets.
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from .. import device as _device
from ..device import to_int_saturating
from ..kernels import ops, pack
from . import entropy as _entropy
from . import sz as _sz
from . import zfp as _zfp
from .embedded import align_blocks, degree_order, k_width
from .transforms import block_transform_nd, blockize, bot_linf_gain, bot_matrix

#: SZ symbol alphabet (escape + shifted residuals), as in core/sz.py
N_SYMBOLS = 2 * _sz.RESIDUAL_RADIUS + 2
#: float32 keeps integers exact below 2^24; SZ codes also pass through
#: Lorenzo corner sums (2^ndim terms), so the code guard is 2^23
_SZ_CODE_LIMIT = 2.0**23
_ZFP_MAG_LIMIT = 2.0**24
#: bit offsets must stay within int32 prefix sums
_MAX_STREAM_BITS = 2**31 - 1

#: device-encode declines by "codec/reason" since the last reset
DECLINES: Counter = Counter()
#: exact counts under the threads of `compress_pytree`'s encoders
_DECLINES_LOCK = threading.Lock()


def _decline(reason: str) -> None:
    with _DECLINES_LOCK:
        DECLINES[reason] += 1
    return None


def _tensor(x, device) -> torch.Tensor:
    """`x` as float32 on its own device if it is a tensor, else on `device`
    (default the GPU, see `repro_torch.device`)."""
    if isinstance(x, torch.Tensor):
        return _device.as_f32(x, x.device)
    return _device.as_f32(x, _device.resolve(device))


# ---------------------------------------------------------------------------
# SZ: two-pass device Huffman
# ---------------------------------------------------------------------------


def _sz_pass1(x: torch.Tensor, eb: float):
    """Quantize + Lorenzo (K1/K2 for 2-D/3-D) -> residuals, symbols,
    histogram, and max|x| for the float32-exactness guard."""
    d = ops.lorenzo_encode(x, eb)
    dl = d.to(torch.int64)
    syms = torch.where(
        dl.abs() > _sz.RESIDUAL_RADIUS, 0, dl + _sz.RESIDUAL_RADIUS + 1
    ).reshape(-1)
    hist = torch.bincount(syms, minlength=N_SYMBOLS)
    amax = torch.amax(x.abs()) if x.numel() else torch.zeros((), device=x.device)
    return d, syms, hist, amax


def _sz_pass2(syms, d, lut_codes, lut_lens, *, n_words, esc_cap, window):
    """Table-lookup gather + prefix-sum pack, and escape compaction by rank
    (`searchsorted` on the escape-count prefix sum)."""
    lens = lut_lens[syms]
    codes = lut_codes[syms]
    offsets = torch.cumsum(lens, 0) - lens  # exclusive
    words = pack.pack_codes_gather(codes, lens, offsets, n_words, window)
    esc_rank = torch.cumsum((syms == 0).to(torch.int64), 0)
    tgt = torch.arange(1, max(esc_cap, 1) + 1, dtype=torch.int64, device=syms.device)
    idx = torch.clamp(
        torch.searchsorted(esc_rank, tgt, right=False), 0, syms.shape[0] - 1
    )
    # lanes past the true escape count gather garbage; the host reads
    # exactly the first n_esc
    escapes = d.reshape(-1)[idx]
    return words, escapes


def sz_device_residuals(x, eb: float, *, device=None) -> np.ndarray:
    """The exact Lorenzo residuals the device encoder packs, for feeding
    `sz.sz_encode_residuals` in parity checks."""
    d, _, _, _ = _sz_pass1(_tensor(x, device), eb)
    return d.cpu().numpy()


def sz_encode_device(x, eb: float, *, device=None) -> bytes | None:
    """Device SZ encode -> SZJ2 container bytes, or None (host fallback).
    `x` is the folded float32 view, a tensor (the encode runs on its
    device) or an array (moved to `device`); `eb` is the SZ bound."""
    x = _tensor(x, device)
    shape = tuple(x.shape)
    size = x.numel()
    if size == 0 or eb <= 0:
        return _decline("sz/empty_or_bound")
    delta32 = np.float32(2.0) * np.float32(eb)
    if not np.isfinite(float(delta32)) or float(delta32) <= 0.0:
        return _decline("sz/delta")
    d, syms, hist, amax = _sz_pass1(x, eb)
    freqs = hist.cpu().numpy().astype(np.int64)
    amax = float(amax)
    if not np.isfinite(amax) or amax / float(delta32) >= _SZ_CODE_LIMIT:
        return _decline("sz/code_range")
    table = _entropy.build_table(freqs)
    payload_bits = int((freqs * table.lens.astype(np.int64)).sum())
    if payload_bits > _MAX_STREAM_BITS:
        return _decline("sz/stream_bits")
    n_esc = int(freqs[0])
    n_words = pack.arena_words(payload_bits)
    esc_cap = pack.arena_words(32 * n_esc) if n_esc else 0
    # payload_bits is exact, so these cannot under-size; the arena drops
    # out-of-range writes, so guard the invariant anyway
    if 32 * n_words < payload_bits or esc_cap < n_esc:
        return _decline("sz/arena")
    emitted = table.lens[(freqs > 0) & (table.lens > 0)]
    min_len = int(emitted.min()) if emitted.size else 1
    words, escapes = _sz_pass2(
        syms, d,
        torch.as_tensor(table.codes.astype(np.int64), device=x.device),
        torch.as_tensor(table.lens.astype(np.int64), device=x.device),
        n_words=n_words, esc_cap=esc_cap, window=pack.gather_window(min_len),
    )
    payload = pack.words_to_bytes(words, payload_bits)
    outliers = escapes[:n_esc].cpu().numpy().astype(np.int64)
    # the container records the float32 bin size the device divided by
    return _sz.sz_container(
        shape, float(delta32), table, payload, outliers, magic=_sz.DEVICE_MAGIC
    )


# ---------------------------------------------------------------------------
# ZFP: model-sized arena + closed-form plane emission
# ---------------------------------------------------------------------------


def _zfp_pass1(x: torch.Tensor, transform: str):
    """Blockize + exponent-align + BOT, float32. The exponents take the exact
    `log2`, as the host coder's float64 numpy does, so the codes are its."""
    blocks, _ = blockize(x)
    norm, e = align_blocks(blocks, exact=True)
    return block_transform_nd(norm, bot_matrix(transform), x.ndim), e


def _zfp_pass2a(coeffs: torch.Tensor, step: torch.Tensor, nd: int):
    """Plane magnitudes in degree order, and the closed-form `block_bits`
    payload model that sizes the arena: w*maxplane + sum(nsb) + 2*nsig per
    block (headers live in the e/nsb side arrays). The reference's types:
    magnitudes int32 (clamped at the 2^24 guard, so callers check `mmax`
    before using them), bit lengths int8. `coeffs` is non-empty."""
    bsz = 4**nd
    w = k_width(bsz)
    nblk = coeffs.shape[0]
    order = torch.as_tensor(degree_order(nd), device=coeffs.device)
    c = coeffs.reshape(nblk, bsz)[:, order]
    mf = torch.trunc(c.abs() / step[:, None])
    mmax = torch.amax(mf)
    m = to_int_saturating(torch.clamp_max(mf, _ZFP_MAG_LIMIT))
    del mf
    neg = c < 0
    # exact bit length of m <= 2^24 (0 for 0), from its float32 exponent
    nc = torch.frexp(m.to(torch.float32)).exponent.to(torch.int8)
    nsb = torch.amax(nc, dim=1)
    model = w * nsb.sum() + nc.sum() + 2 * (m > 0).sum()
    return m, neg, nc, nsb, model, mmax


def _excl_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count along the block's coefficients, int8
    (bsz <= 64)."""
    m8 = mask.to(torch.int8)
    return torch.cumsum(m8, dim=1, dtype=torch.int8) - m8


def _partvals(mask, bits, rank, cnt):
    """Right-aligned values of a section's lo (ranks < 32) and hi (ranks >=
    32) 32-bit chunks per block, as masked shift-sums in int32: the bits of
    a chunk are distinct, so the sum never carries, and bit 31 lands in
    the sign (the packer masks it back to 32 bits). `rank` is int8, `cnt`
    the section's length per block."""
    cnt = cnt[:, None]
    expo = torch.clamp(cnt - 1 - rank, 0, 31)
    sh_lo = torch.clamp(torch.where(cnt > 32, 31 - rank, expo), 0, 31)
    lo = mask & (rank < 32)
    v_lo = torch.where(lo, bits << sh_lo, 0).sum(dim=1, dtype=torch.int32)
    v_hi = torch.where(mask & ~lo, bits << expo, 0).sum(dim=1, dtype=torch.int32)
    cnt = cnt[:, 0]
    return v_lo, torch.clamp_max(cnt, 32), v_hi, torch.clamp_min(cnt - 32, 0)


def _zfp_plane(m, neg, nc, nsb, p: int, w: int, rank_ref, rank_hi):
    """(lens, vals) of plane p's emission: per block, in stream order, the
    refinement chunks, then the k fields, then test chunks, then sign
    chunks — `zfp._emit_planes` in closed form over bit lengths.

    At plane p a coefficient is already significant iff nc >= p+2 and
    becomes significant iff nc == p+1 (which is also its tested bit). The
    ranks are exclusive prefix counts of the shared masks nc >= t: the
    caller passes those of t = p+2 (`rank_ref`, the previous plane's
    `rank_hi`) and t = p+1 (`rank_hi`)."""
    bsz = m.shape[1]
    act = (p < nsb)[:, None]
    ref = nc >= p + 2
    newly = nc == p + 1
    rank_sign = rank_hi - rank_ref
    rank_rem = torch.arange(bsz, dtype=torch.int8, device=m.device)[None, :] - rank_ref
    rem = act & ~ref
    k = torch.amax(torch.where(newly, rank_rem + 1, 0), dim=1)
    cnt_rem = rem.sum(dim=1, dtype=torch.int32)
    has_rem = act[:, 0] & (cnt_rem > 0)
    test = rem & (rank_rem < k[:, None])
    refbit = (m >> p) & 1
    rA, rlA, rB, rlB = _partvals(ref, refbit, rank_ref, ref.sum(dim=1, dtype=torch.int32))
    tA, tlA, tB, tlB = _partvals(
        test, newly.to(torch.int32), rank_rem, torch.minimum(k.to(torch.int32), cnt_rem)
    )
    sA, slA, sB, slB = _partvals(
        newly, neg.to(torch.int32), rank_sign, newly.sum(dim=1, dtype=torch.int32)
    )
    klen = torch.where(has_rem, w, 0).to(torch.int32)

    def inter(a, b):
        return torch.stack([a, b], dim=1).reshape(-1)

    lens = torch.cat([inter(rlA, rlB), klen, inter(tlA, tlB), inter(slA, slB)])
    vals = torch.cat([inter(rA, rB), k.to(torch.int32), inter(tA, tB), inter(sA, sB)])
    return lens, vals


def _zfp_pass2b(m, neg, nc, nsb, *, n_words: int, n_planes: int):
    """The plane-sectioned k-prefix emitter: planes descending, each plane's
    chunks from `_zfp_plane` packed into the arena as soon as they exist,
    at offsets continuing the previous planes' (int32: the caller bounds the
    stream below 2^31 bits). Returns (words, total bits)."""
    words = torch.zeros(n_words, dtype=torch.int64, device=m.device)
    if n_planes == 0:
        return words, 0
    w = k_width(m.shape[1])
    base = torch.zeros((), dtype=torch.int32, device=m.device)
    rank_ref = _excl_cumsum(nc >= n_planes + 1)
    for p in range(n_planes - 1, -1, -1):
        rank_hi = _excl_cumsum(nc >= p + 1)
        lens, vals = _zfp_plane(m, neg, nc, nsb, p, w, rank_ref, rank_hi)
        offs = torch.cumsum(lens, 0, dtype=torch.int32) - lens + base
        pack.pack_codes(vals, lens, offs, n_words, words=words)
        base = base + lens.sum(dtype=torch.int32)
        rank_ref = rank_hi
    return words, int(base)


def _zfp_step(e_np: np.ndarray, eb: float, gain_n: float) -> np.ndarray | None:
    """The power-of-two truncation step, float64, exactly as the decoder
    (and `_prepare_blocks`) evaluates it, then cast to float32 (powers of
    two are exact). None when it leaves float32 range."""
    raw = eb / (np.exp2(e_np.astype(np.float64)) * gain_n)
    pexp = np.floor(np.log2(np.maximum(raw, 2.0**-60)))
    if pexp.size and (pexp.min() < -126 or pexp.max() > 127):
        return None
    return np.exp2(pexp).astype(np.float32)


def zfp_device_codes(x, eb: float, transform: str = "zfp", *, device=None):
    """Device-computed quantized codes (q, e) in raw block layout, for
    feeding `zfp.zfp_encode_quantized` in parity checks."""
    x = _tensor(x, device)
    coeffs, e = _zfp_pass1(x, transform)
    e_np = e.cpu().numpy().astype(np.int16)
    step = _zfp_step(e_np, eb, bot_linf_gain(transform) ** x.ndim)
    if step is None:
        raise ValueError("ZFP plane step outside float32 range")
    # c / step is exact in float32 (power-of-two step), so the float64
    # trunc reproduces the device's plane magnitudes bit for bit
    c = coeffs.cpu().numpy().astype(np.float64).reshape(len(e_np), -1)
    q = np.trunc(c / step.astype(np.float64)[:, None]).astype(np.int64)
    return q, e_np


def zfp_encode_device(
    x, eb: float, transform: str = "zfp", *, device=None
) -> bytes | None:
    """Device ZFP encode -> ZFJX container bytes, or None (host fallback).
    `x` as for `sz_encode_device`; `eb` is the absolute bound."""
    x = _tensor(x, device)
    shape = tuple(x.shape)
    if x.numel() == 0 or eb <= 0 or not np.isfinite(eb):
        return _decline("zfp/empty_or_bound")
    nd = x.ndim
    bsz = 4**nd
    w = k_width(bsz)
    padded = tuple(s + (-s) % 4 for s in shape)
    coeffs, e = _zfp_pass1(x, transform)
    e_np = e.cpu().numpy().astype(np.int16)
    nblk = len(e_np)
    step = _zfp_step(e_np, eb, bot_linf_gain(transform) ** nd)
    if step is None:
        return _decline("zfp/step_range")
    m, neg, nc, nsb, model, mmax = _zfp_pass2a(
        coeffs, torch.as_tensor(step, device=x.device), nd
    )
    mmax = float(mmax)
    if not np.isfinite(mmax) or mmax >= _ZFP_MAG_LIMIT:
        return _decline("zfp/code_range")
    maxp = int(nsb.max())
    n_planes = min(24, -(-maxp // 4) * 4) if maxp else 0
    # int32 bit-offset headroom for the worst-case emission of this field
    if nblk * (3 * bsz + w) * max(n_planes, 1) > _MAX_STREAM_BITS:
        return _decline("zfp/stream_bits")
    n_words = pack.arena_words(int(model))
    words, total_bits = _zfp_pass2b(m, neg, nc, nsb, n_words=n_words, n_planes=n_planes)
    if total_bits > 32 * n_words:
        # the block_bits model under-estimated: the arena dropped bits, so
        # the field takes the host coder, never a truncated stream
        return _decline("zfp/arena")
    payload = pack.words_to_bytes(words, total_bits)
    return _zfp.zfp_container(
        shape, padded, float(eb), transform, e_np,
        nsb.cpu().numpy().astype(np.uint8), total_bits, payload,
    )


# ---------------------------------------------------------------------------
# registry surface
# ---------------------------------------------------------------------------


def encode_field_device(view32, sel) -> bytes | None:
    """Dispatch one folded float32 view to the device encoder for its
    selected codec. None -> the caller uses the host coder."""
    if sel.codec == "sz":
        return sz_encode_device(view32, sel.eb_sz)
    if sel.codec == "zfp":
        return zfp_encode_device(view32, sel.eb_abs)
    return None
