"""The plain reference's stream decoders: SZ (``SZJ1``/``SZJ2``) and ZFP
(``ZFJX``) containers back to float32 arrays, in numpy.

A frozen copy of the program's host decoders (`core/sz.py`,
`core/entropy.py`, `core/zfp.py`), which define the stream formats. It
imports nothing of the program: the benchmark judges the program's
streams with it, so a later change to the program's decoders cannot move
what the benchmark accepts.
"""

from __future__ import annotations

import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# ---------------------------------------------------------------------------
# SZ: canonical Huffman payload, integer Lorenzo residuals, linear bins
# ---------------------------------------------------------------------------

RESIDUAL_RADIUS = 32767
SZ_MAGICS = (b"SZJ1", b"SZJ2")
ZFP_MAGIC = b"ZFJX"


def _canonical_codes(lens: np.ndarray) -> np.ndarray:
    codes = np.zeros(len(lens), dtype=np.uint64)
    order = np.lexsort((np.arange(len(lens)), lens))
    code = 0
    prev_len = 0
    for s in order:
        ln = int(lens[s])
        if ln == 0:
            continue
        code <<= ln - prev_len
        codes[s] = code
        code += 1
        prev_len = ln
    return codes


def _table_from_bytes(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(lens, codes) of a serialised canonical Huffman table."""
    k, n = np.frombuffer(buf[:8], dtype=np.uint32)
    flag = buf[8]
    blob = buf[9:]
    if flag:
        import zstandard

        blob = zstandard.ZstdDecompressor().decompress(blob)
    deltas = np.frombuffer(blob[: 4 * n], dtype=np.uint32).astype(np.int64)
    used = np.cumsum(deltas)
    lens = np.zeros(k, dtype=np.int32)
    lens[used] = np.frombuffer(blob[4 * n : 5 * n], dtype=np.uint8)
    return lens, _canonical_codes(lens)


def _windows(words: np.ndarray, pos: np.ndarray, maxlen: int) -> np.ndarray:
    return (words[pos >> 3] >> (32 - maxlen - (pos & 7))) & ((1 << maxlen) - 1)


def huffman_decode(buf: bytes, lens: np.ndarray, codes: np.ndarray, count: int) -> np.ndarray:
    """`count` symbols of a canonical Huffman bit stream, MSB first: every
    segment of the stream walked at once, then the true codeword
    boundaries found where each segment's walk meets its re-walk from the
    previous segment's exit (Huffman codes resynchronise)."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    maxlen = int(lens.max())
    lut_sym = np.zeros(1 << maxlen, dtype=np.int64)
    lut_len = np.zeros(1 << maxlen, dtype=np.int64)
    for s in np.flatnonzero(lens):
        ln = int(lens[s])
        prefix = int(codes[s]) << (maxlen - ln)
        span = 1 << (maxlen - ln)
        lut_sym[prefix : prefix + span] = s
        lut_len[prefix : prefix + span] = ln
    step = np.maximum(lut_len, 1)
    b = np.frombuffer(bytes(buf) + bytes(4), dtype=np.uint8).astype(np.int64)
    words = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    nbits = 8 * len(buf)
    seg = max(512, -(-nbits // 65536))
    starts = np.arange(0, nbits, seg, dtype=np.int64)
    ends = np.minimum(starts + seg, nbits)

    def advance(p):
        return p + step[_windows(words, p, maxlen)]

    seen = np.zeros(nbits, dtype=bool)
    exits = starts.copy()
    lanes, p = np.arange(len(starts)), starts.copy()
    while lanes.size:
        seen[p] = True
        p = advance(p)
        exits[lanes] = p
        inside = p < ends[lanes]
        lanes, p = lanes[inside], p[inside]

    entry = starts.copy()
    meet = starts.copy()
    true_exit = exits.copy()
    while True:
        want = np.concatenate(([0], true_exit[:-1]))
        lanes = np.flatnonzero(want != entry)
        if not lanes.size:
            break
        entry[lanes] = want[lanes]
        todo, p = np.arange(len(lanes)), entry[lanes]
        while todo.size:
            lane = lanes[todo]
            inside = p < ends[lane]
            hit = np.zeros(len(todo), dtype=bool)
            hit[inside] = seen[p[inside]]
            done = hit | ~inside
            d = lane[done]
            meet[d] = np.where(hit[done], p[done], ends[d])
            true_exit[d] = np.where(hit[done], exits[d], p[done])
            todo, p = todo[~done], advance(p[~done])

    own = np.flatnonzero(seen)
    seen[own[own < meet[own // seg]]] = False
    lanes = np.flatnonzero(entry < meet)
    p = entry[lanes]
    while lanes.size:
        seen[p] = True
        p = advance(p)
        before = p < meet[lanes]
        lanes, p = lanes[before], p[before]
    pos = np.flatnonzero(seen)[:count]
    if len(pos) < count:
        raise ValueError(f"Huffman stream holds {len(pos)} codewords, {count} expected")
    return lut_sym[_windows(words, pos, maxlen)]


def sz_decode(buf: bytes) -> np.ndarray:
    off = 0
    magic, ndim, delta, size, n_out = struct.unpack_from("<4sBdQI", buf, off)
    if magic not in SZ_MAGICS:
        raise ValueError(f"not an SZ stream (magic {magic!r})")
    off += struct.calcsize("<4sBdQI")
    shape = struct.unpack_from(f"<{ndim}q", buf, off)
    off += 8 * ndim
    (tbl_len,) = struct.unpack_from("<I", buf, off)
    off += 4
    lens, codes = _table_from_bytes(buf[off : off + tbl_len])
    off += tbl_len
    (pay_len,) = struct.unpack_from("<Q", buf, off)
    off += 8
    syms = huffman_decode(buf[off : off + pay_len], lens, codes, size)
    off += pay_len
    outliers = np.frombuffer(buf[off : off + 8 * n_out], dtype=np.int64)
    if len(outliers) != n_out or int((syms == 0).sum()) != n_out:
        raise ValueError("SZ stream: escape count and outlier section disagree")
    d = syms - (RESIDUAL_RADIUS + 1)
    d[syms == 0] = outliers
    codes_ = d.reshape(shape)
    for ax in range(codes_.ndim):
        codes_ = np.cumsum(codes_, axis=ax)
    return (codes_.astype(np.float64) * delta).astype(np.float32)


# ---------------------------------------------------------------------------
# ZFP: block transform, bit-plane truncation, plane-major k-prefix coder
# ---------------------------------------------------------------------------

#: the transform's parameter t of the paper's T(t), by stream name
BOT_PRESETS = {
    "hwt": 0.0,
    "dct2": 0.25,
    "slant": (2.0 / math.pi) * math.atan(1.0 / 3.0),
    "high_corr": (2.0 / math.pi) * math.atan(1.0 / 2.0),
    "wht": 0.5,
    "zfp": (2.0 / math.pi) * math.atan(1.0 / 2.0),
}
#: blocks read at a time, each chunk on a thread of its own
CHUNK = 1 << 15


def bot_matrix(name: str) -> np.ndarray:
    t = BOT_PRESETS[name]
    s = math.sqrt(2.0) * math.sin(math.pi / 2.0 * t)
    c = math.sqrt(2.0) * math.cos(math.pi / 2.0 * t)
    return 0.5 * np.array(
        [[1.0, 1.0, 1.0, 1.0], [c, s, -s, -c], [1.0, -1.0, -1.0, 1.0], [s, -c, c, -s]],
        dtype=np.float64,
    )


def bot_linf_gain(name: str) -> float:
    return float(np.abs(bot_matrix(name).T).sum(axis=1).max())


def degree_order(nd: int) -> np.ndarray:
    idx = np.indices((4,) * nd).reshape(nd, -1).sum(axis=0)
    return np.argsort(idx, kind="stable")


def k_width(bsz: int) -> int:
    return int(np.ceil(np.log2(bsz + 1)))


def _map_chunks(fn, n: int) -> list:
    if n <= 1:
        return [fn(i) for i in range(n)]
    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, range(n)))


def _read_planes(bits: np.ndarray, nblk: int, bsz: int, nsb: np.ndarray):
    """Block magnitudes and signs of the plane-major coder: per plane,
    four sections over all blocks (refinement bits of significant
    coefficients; the k fields; significance bits of the first k remaining
    coefficients; signs of the newly significant)."""
    m = np.zeros((nblk, bsz), dtype=np.int64)
    neg = np.zeros((nblk, bsz), dtype=bool)
    w = k_width(bsz)
    kweights = (1 << np.arange(w - 1, -1, -1)).astype(np.int64)
    maxp = int(nsb.max()) if nsb.size else 0
    n = -(-nblk // CHUNK)
    state: list = [None] * n
    pos = 0

    def offsets(counts: list) -> list:
        nonlocal pos
        at = pos + np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
        pos += int(sum(counts))
        return [int(v) for v in at]

    for p in range(maxp - 1, -1, -1):
        def open_plane(i: int) -> tuple[int, int]:
            lo = i * CHUNK
            mc, negc = m[lo : lo + CHUNK], neg[lo : lo + CHUNK]
            active = nsb[lo : lo + CHUNK] > p
            if not active.any():
                state[i] = None
                return 0, 0
            blk = None if active.all() else np.flatnonzero(active)
            ma = mc if blk is None else mc[blk]
            sig_prev = ma > 0
            ma <<= 1
            rem = ~sig_prev
            has_rem = rem.any(axis=1)
            state[i] = [mc, negc, blk, ma, sig_prev, rem, has_rem]
            return int(sig_prev.sum()), int(has_rem.sum()) * w

        counts = _map_chunks(open_plane, n)
        ref_at = offsets([c[0] for c in counts])
        k_at = offsets([c[1] for c in counts])

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
    if pos != len(bits):
        raise ValueError(f"ZFP stream: planes hold {pos} bits, header says {len(bits)}")
    return m, neg


def _unblockize(blocks: np.ndarray, padded: tuple, shape: tuple) -> np.ndarray:
    nd = len(padded)
    grid = [s // 4 for s in padded]
    x = blocks.reshape(tuple(grid) + (4,) * nd)
    perm = []
    for i in range(nd):
        perm += [i, nd + i]
    x = x.transpose(perm).reshape(padded)
    return x[tuple(slice(0, s) for s in shape)]


def zfp_decode(buf: bytes) -> np.ndarray:
    off = 0
    magic, n, eb, nblk = struct.unpack_from("<4sBdQ", buf, off)
    if magic != ZFP_MAGIC:
        raise ValueError(f"not a ZFP stream (magic {magic!r})")
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
    if len(bits) != nbits:
        raise ValueError("ZFP stream shorter than its header says")
    bsz = 4**n
    m, neg = _read_planes(bits, nblk, bsz, nsb.astype(np.int64))
    inv = np.argsort(degree_order(n))
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
    return np.ascontiguousarray(_unblockize(rec.astype(np.float32), padded, shape))


def decode(codec: str, buf: bytes, shape: tuple) -> np.ndarray:
    """A field's stream back to a float32 array of `shape`."""
    if codec == "sz":
        out = sz_decode(buf)
    elif codec == "zfp":
        out = zfp_decode(buf)
    elif codec == "raw":
        out = np.frombuffer(buf, dtype=np.float32)
    else:
        raise ValueError(f"unknown codec {codec!r}")
    return out.reshape(shape)
