"""Device-resident bitstream packing: the 32-bit word-arena packer.

Port of `repro.kernels.pack` as torch ops (the reference's are jnp, not
Pallas). Both device encoders (`core/device_encode.py`) reduce their
variable-length output to a monotone sequence of (bit offset, value,
length) writes into a preallocated arena of 32-bit words:

* `pack_codes` — scatter form: each write lands in at most two words;
  zero-length writes are free.
* `pack_codes_gather` — gather form: each word sums the shifted
  contributions of the bounded window of codes that can overlap it; every
  length must be >= 1 (the SZ Huffman stream qualifies).

Layout: bit `b` of the stream lives in word `b >> 5` at bit `31 - (b & 31)`
(MSB first), so the byte-swapped words truncated to ``ceil(nbits/8)`` bytes
are exactly what `np.packbits` gives for the same bits. Words are held in
int64 tensors with values below 2^32 (torch has no full uint32 arithmetic);
codes arrive in up to 32 bits (int32 codes with bit 31 in the sign), and
every shift is masked back to 32 bits, so results equal uint32 arithmetic.
Offsets are exclusive prefix sums, so writes never collide on a bit and
adding is or-ing. Writes past the arena are dropped: the arena can
truncate but never corrupt, and callers detect truncation from the true
bit total.
"""

from __future__ import annotations

import numpy as np
import torch

#: arena word width; the packer's only unit
WORD_BITS = 32
_MASK = (1 << WORD_BITS) - 1
#: elements per (words x window) temporary of the gather packer
_GATHER_CHUNK = 1 << 24
#: codes per chunk of the scatter packer
_SCATTER_CHUNK = 1 << 22


def arena_words(nbits: int, min_words: int = 64) -> int:
    """Arena size in 32-bit words for a bit budget: the next power of two at
    or above ``ceil(nbits/32)``."""
    need = max(int(min_words), -(-int(nbits) // WORD_BITS))
    return 1 << int(np.ceil(np.log2(need)))


def pack_codes(
    codes: torch.Tensor,
    lens: torch.Tensor,
    offsets: torch.Tensor,
    n_words: int,
    *,
    words: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pack variable-length codes (MSB first) into a word arena (scatter
    form). `codes` hold their codeword in the low `lens[i]` bits (an int32
    code of 32 bits carries bit 31 in its sign), `lens` are in [0, 32],
    `offsets` are the exclusive prefix sum of `lens`. Returns the
    (n_words,) arena as int64 words: a fresh one, or `words`, added into.

    Codes are taken in chunks so the int64 temporaries stay bounded; the
    result does not depend on the chunking (writes never share a bit)."""
    if words is None:
        words = torch.zeros(n_words, dtype=torch.int64, device=codes.device)
    for lo in range(0, codes.shape[0], _SCATTER_CHUNK):
        part = slice(lo, lo + _SCATTER_CHUNK)
        c = codes[part].to(torch.int64) & _MASK
        ln = lens[part].to(torch.int64)
        off = offsets[part].to(torch.int64)
        pos = off & (WORD_BITS - 1)
        w0 = off >> 5
        end = pos + ln
        spill = torch.clamp_min(end - WORD_BITS, 0)
        hi_shift = torch.clamp(WORD_BITS - end, 0, WORD_BITS - 1)
        hi = ((c >> spill) << hi_shift) & _MASK
        lo_shift = torch.clamp(WORD_BITS - spill, 0, WORD_BITS - 1)
        low = torch.where(spill > 0, (c << lo_shift) & _MASK, 0)
        live = ln > 0
        for idx, val in ((w0, hi), (w0 + 1, low)):
            # writes past the arena add 0 to word 0
            keep = live & (idx < n_words)
            words.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, val, 0))
    return words


def gather_window(min_len: int) -> int:
    """Gather window for `pack_codes_gather`: a bound on how many codes can
    overlap one 32-bit word when every code has at least `min_len` bits,
    bucketed to a small set."""
    need = WORD_BITS // max(int(min_len), 1) + 2
    for cap in (6, 10, 18, 34):
        if need <= cap:
            return cap
    return 34


def pack_codes_gather(
    codes: torch.Tensor,
    lens: torch.Tensor,
    offsets: torch.Tensor,
    n_words: int,
    window: int,
) -> torch.Tensor:
    """Pack variable-length codes (MSB first) into a fresh word arena
    (gather form): word `i` is the sum of the shifted contributions of the
    codes overlapping bits [32i, 32i+32). Every `lens[i]` must be in
    [1, 32] and `window >= 32 // min(lens) + 2` (`gather_window`).

    Words are processed in chunks so the (words x window) temporaries stay
    bounded on large fields; the result does not depend on the chunking.
    """
    codes = codes.to(torch.int64)
    lens = lens.to(torch.int64)
    offsets = offsets.to(torch.int64)
    n = codes.shape[0]
    last = max(n - 1, 0)
    dev = codes.device
    out = torch.zeros(n_words, dtype=torch.int64, device=dev)
    lanes = torch.arange(window, dtype=torch.int64, device=dev)[None, :]
    step = max(1, _GATHER_CHUNK // window)
    for lo in range(0, n_words, step):
        hi = min(lo + step, n_words)
        starts = torch.arange(lo, hi, dtype=torch.int64, device=dev) * WORD_BITS
        first = torch.searchsorted(offsets, starts, right=True) - 1
        j = torch.clamp(first, 0, last)[:, None] + lanes
        jc = torch.clamp(j, 0, last)
        off = offsets[jc]
        ln = lens[jc]
        c = codes[jc]
        # t: how many bits of code j extend past this word's start
        t = off + ln - starts[:, None]
        live = (j < n) & (t > 0) & (off < starts[:, None] + WORD_BITS)
        contrib = torch.where(
            t > WORD_BITS,
            c >> torch.clamp(t - WORD_BITS, 0, WORD_BITS - 1),
            (c << torch.clamp(WORD_BITS - t, 0, WORD_BITS - 1)) & _MASK,
        )
        out[lo:hi] = torch.where(live, contrib, 0).sum(dim=1)
    return out


def words_to_bytes(words, nbits: int) -> bytes:
    """Host finalizer: big-endian word arena -> the exact `np.packbits`
    byte stream for `nbits` bits."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    nbytes = -(-int(nbits) // 8)
    return np.asarray(words).astype(np.uint32).byteswap().tobytes()[:nbytes]
