"""Stage III lossless entropy coding (paper §5.1.1, Fig. 1).

The port's own copy of `repro.core.entropy`: the host-side (numpy)
canonical Huffman coder behind the SZ byte streams, plus the Shannon-entropy
bit-rate of a histogram (Eq. (5)). Numpy only; the port keeps its own copy
because importing any `repro.core` module pulls in JAX. Streams are
byte-identical to the reference's, the zstd-flagged table serialization
included.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

MAX_CODE_LEN = 24
ESCAPE = 0  # symbol 0 of the shifted alphabet is the escape symbol


def _zstd():
    """Optional: zstandard shrinks the serialized Huffman table a bit; the
    codec must still work without it, so streams carry a flag byte and
    fall back to the raw table blob when it is absent."""
    try:
        import zstandard

        return zstandard
    except ImportError:
        return None


def entropy_bits(hist: np.ndarray) -> float:
    """Shannon entropy (bits/value) of a histogram — Eq. (5)."""
    p = hist.astype(np.float64)
    tot = p.sum()
    if tot <= 0:
        return 0.0
    p = p[p > 0] / tot
    return float(-(p * np.log2(p)).sum())


# ---------------------------------------------------------------------------
# Canonical Huffman
# ---------------------------------------------------------------------------


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths; dampen frequencies until max length fits."""
    f = freqs.astype(np.int64).copy()
    while True:
        lens = _huffman_lengths(f)
        if lens.max(initial=0) <= MAX_CODE_LEN:
            return lens
        f = (f + 1) // 2  # flatten the distribution, retry

def _huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    sym = np.nonzero(freqs)[0]
    lens = np.zeros(len(freqs), dtype=np.int32)
    if len(sym) == 0:
        return lens
    if len(sym) == 1:
        lens[sym[0]] = 1
        return lens
    heap = [(int(freqs[s]), int(s), (int(s),)) for s in sym]
    heapq.heapify(heap)
    cnt = len(freqs)
    while len(heap) > 1:
        f1, _, g1 = heapq.heappop(heap)
        f2, _, g2 = heapq.heappop(heap)
        for s in g1 + g2:
            lens[s] += 1
        heapq.heappush(heap, (f1 + f2, cnt, g1 + g2))
        cnt += 1
    return lens


def _canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Assign canonical codewords (MSB-first) from code lengths."""
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


@dataclass
class HuffmanTable:
    lens: np.ndarray   # (K,) int32
    codes: np.ndarray  # (K,) uint64, canonical, MSB-first

    def to_bytes(self) -> bytes:
        """Sparse serialization: (K, n_used) + flag byte + delta-coded
        symbols + lens, zstd-compressed when available (symbol runs are
        near-contiguous, lens are small), raw otherwise."""
        used = np.nonzero(self.lens)[0].astype(np.int64)
        deltas = np.diff(used, prepend=0).astype(np.uint32)
        blob = deltas.tobytes() + self.lens[used].astype(np.uint8).tobytes()
        z = _zstd()
        flag = 1 if z is not None else 0
        if z is not None:
            blob = z.ZstdCompressor(level=9).compress(blob)
        hdr = np.array([len(self.lens), len(used)], dtype=np.uint32).tobytes()
        return hdr + bytes([flag]) + blob

    @staticmethod
    def from_bytes(buf: bytes) -> "HuffmanTable":
        k, n = np.frombuffer(buf[:8], dtype=np.uint32)
        flag = buf[8]
        blob = buf[9:]
        if flag:
            z = _zstd()
            if z is None:
                raise RuntimeError(
                    "stream's Huffman table is zstd-compressed but the "
                    "'zstandard' package is not installed"
                )
            blob = z.ZstdDecompressor().decompress(blob)
        deltas = np.frombuffer(blob[: 4 * n], dtype=np.uint32).astype(np.int64)
        used = np.cumsum(deltas)
        lens = np.zeros(k, dtype=np.int32)
        lens[used] = np.frombuffer(blob[4 * n : 5 * n], dtype=np.uint8)
        return HuffmanTable(lens, _canonical_codes(lens))


def build_table(freqs: np.ndarray) -> HuffmanTable:
    lens = _code_lengths(freqs)
    return HuffmanTable(lens, _canonical_codes(lens))


def encode(symbols: np.ndarray, table: HuffmanTable) -> bytes:
    """Vectorized Huffman encode: per-symbol bit expansion + packbits."""
    lens = table.lens[symbols]
    total = int(lens.sum())
    if total == 0:
        return b""
    offsets = np.zeros(len(symbols) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    src = np.repeat(np.arange(len(symbols), dtype=np.int64), lens)
    bitpos = np.arange(total, dtype=np.int64) - offsets[src]
    words = table.codes[symbols][src]
    shifts = (lens[src] - 1 - bitpos).astype(np.uint64)
    bits = ((words >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits).tobytes()


def _windows(words: np.ndarray, pos: np.ndarray, maxlen: int) -> np.ndarray:
    """The `maxlen` stream bits from each bit offset in `pos` on, MSB first,
    as ints; `words[k]` holds bytes k..k+3 big-endian (maxlen + 7 <= 32)."""
    return (words[pos >> 3] >> (32 - maxlen - (pos & 7))) & ((1 << maxlen) - 1)


def decode(buf: bytes, table: HuffmanTable, count: int) -> np.ndarray:
    """Table-driven canonical Huffman decode (dense 2^maxlen lookup),
    vectorized over segments of the bit stream.

    Each segment is walked from its first bit at once, as if a codeword
    began there. The true walk enters a segment at the first codeword
    boundary past its start; re-walked from there, it meets the segment's
    own walk within a few codewords (Huffman codes resynchronize) and
    follows it from that bit on. So the codeword boundaries are the
    re-walks up to each meeting point and the segments' own walks after
    it; entries move on until no segment's exit changes. The symbols are
    the reference's sequential walk's, bit for bit."""
    if count == 0:
        return np.zeros(0, dtype=np.int64)
    maxlen = int(table.lens.max())
    # dense lookup: top `maxlen` bits -> (symbol, length)
    lut_sym = np.zeros(1 << maxlen, dtype=np.int64)
    lut_len = np.zeros(1 << maxlen, dtype=np.int64)
    for s in range(len(table.lens)):
        l = int(table.lens[s])
        if l == 0:
            continue
        prefix = int(table.codes[s]) << (maxlen - l)
        span = 1 << (maxlen - l)
        lut_sym[prefix : prefix + span] = s
        lut_len[prefix : prefix + span] = l
    # a window no codeword starts (an incomplete code, read off a codeword
    # boundary) steps one bit, so every walk moves on
    step = np.maximum(lut_len, 1)
    b = np.frombuffer(bytes(buf) + bytes(4), dtype=np.uint8).astype(np.int64)
    words = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    nbits = 8 * len(buf)
    seg = max(512, -(-nbits // 65536))
    starts = np.arange(0, nbits, seg, dtype=np.int64)
    ends = np.minimum(starts + seg, nbits)

    def advance(p):
        return p + step[_windows(words, p, maxlen)]

    # 1) each segment's own walk: its boundaries in `seen`, its exit
    seen = np.zeros(nbits, dtype=bool)
    exits = starts.copy()
    lanes, p = np.arange(len(starts)), starts.copy()
    while lanes.size:
        seen[p] = True
        p = advance(p)
        exits[lanes] = p
        inside = p < ends[lanes]
        lanes, p = lanes[inside], p[inside]

    # 2) the true entries: re-walk a segment from its entry until it meets
    # the segment's own walk (then it leaves where that walk left) or the
    # segment's end; repeat while an exit, and so the next entry, changes
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

    # 3) the boundaries: each segment's own walk from its meeting point on,
    # and its re-walk from its entry up to the meeting point
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
