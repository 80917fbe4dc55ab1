"""The port's device-resident Stage III (run on the CPU here).

Fed the same codes, the device packers and the host Stage III give
byte-identical streams; and on the same float32 input the port's device
streams equal the reference's `repro.core.device_encode` streams. Every
fallback guard returns None and is counted in `device_encode.DECLINES`.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import device_encode as r_de
from repro_torch.core import device_encode as de
from repro_torch.core import selector, sz, zfp
from repro_torch.kernels import pack

SHAPES = [(2048,), (96, 80), (24, 40, 32), (30, 29)]
KINDS = ["smooth", "walk"]


def _field(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        grids = np.meshgrid(*[np.linspace(0, 4, s) for s in shape], indexing="ij")
        out = np.ones(shape)
        for g in grids:
            out = out * np.sin(g)
        return (out + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _eb(x, rel=1e-3):
    return rel * float(x.max() - x.min())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_sz_device_stream_equals_host_coder(shape, kind):
    x = _field(shape, kind, 3)
    eb = _eb(x)
    dev = de.sz_encode_device(torch.from_numpy(x), eb)
    assert dev is not None
    d = de.sz_device_residuals(torch.from_numpy(x), eb)
    delta = float(np.float32(2.0) * np.float32(eb))
    assert dev == sz.sz_encode_residuals(d, x.shape, delta, magic=sz.DEVICE_MAGIC)
    out = sz.sz_decompress(dev)
    assert np.max(np.abs(out - x)) <= eb + 4 * np.spacing(np.abs(x).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_sz_device_stream_equals_reference(shape, kind):
    x = _field(shape, kind, 4)
    eb = _eb(x)
    assert de.sz_encode_device(torch.from_numpy(x), eb) == r_de.sz_encode_device(x, eb)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_zfp_device_stream_equals_host_coder(shape, kind):
    x = _field(shape, kind, 5)
    eb = _eb(x)
    dev = de.zfp_encode_device(torch.from_numpy(x), eb)
    assert dev is not None
    q, e = de.zfp_device_codes(torch.from_numpy(x), eb)
    padded = tuple(s + (-s) % 4 for s in x.shape)
    assert dev == zfp.zfp_encode_quantized(q, e, x.shape, padded, eb)
    out = zfp.zfp_decompress(dev)
    assert np.max(np.abs(out - x)) <= eb + 4 * np.spacing(np.abs(x).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_zfp_device_stream_equals_reference(shape, kind):
    x = _field(shape, kind, 6)
    eb = _eb(x)
    assert de.zfp_encode_device(torch.from_numpy(x), eb) == r_de.zfp_encode_device(x, eb)


def test_sz_escape_heavy_stream_equals_reference():
    """Outliers past RESIDUAL_RADIUS exercise the escape compaction."""
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.standard_normal((64, 64)), axis=0).astype(np.float32)
    x[::7, ::5] += 1e4 * rng.standard_normal(x[::7, ::5].shape).astype(np.float32)
    eb = 1e-6 * float(x.max() - x.min())
    ours = de.sz_encode_device(torch.from_numpy(x), eb)
    assert ours is not None and ours == r_de.sz_encode_device(x, eb)
    d = de.sz_device_residuals(torch.from_numpy(x), eb)
    assert int(np.sum(np.abs(d) > sz.RESIDUAL_RADIUS)) > 0


@pytest.mark.parametrize("rel", [1e-1, 1e-5])
def test_zfp_wide_plane_range_equals_reference(rel):
    """Loose and tight bounds: few planes, and many (ranks past 32)."""
    x = _field((16, 20, 24), "walk", 8)
    eb = _eb(x, rel)
    assert de.zfp_encode_device(torch.from_numpy(x), eb) == r_de.zfp_encode_device(x, eb)


def test_pack_scatter_and_gather_agree_with_packbits():
    rng = np.random.default_rng(9)
    lens = rng.integers(1, 33, size=700)
    codes = rng.integers(0, 2**32, size=700, dtype=np.uint64) & ((1 << lens.astype(np.uint64)) - 1)
    offsets = np.cumsum(lens) - lens
    nbits = int(lens.sum())
    bits = np.concatenate([
        ((int(c) >> np.arange(n - 1, -1, -1)) & 1).astype(np.uint8) for c, n in zip(codes, lens)
    ])
    want = np.packbits(bits).tobytes()
    n_words = pack.arena_words(nbits)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (codes, lens, offsets)]
    assert pack.words_to_bytes(pack.pack_codes(*t, n_words), nbits) == want
    window = pack.gather_window(int(lens.min()))
    assert pack.words_to_bytes(pack.pack_codes_gather(*t, n_words, window), nbits) == want
    # a short arena truncates (drops) writes but never corrupts the words it has
    short = pack.pack_codes(*t, 8)
    assert pack.words_to_bytes(short, 256) == want[:32]


def _declines(reason, fn):
    before = de.DECLINES[reason]
    assert fn() is None
    assert de.DECLINES[reason] == before + 1


def test_sz_guards_return_none_and_count(monkeypatch):
    x = torch.from_numpy(_field((32, 32), "walk", 1))
    _declines("sz/empty_or_bound", lambda: de.sz_encode_device(torch.zeros(0), 0.1))
    _declines("sz/empty_or_bound", lambda: de.sz_encode_device(x, 0.0))
    with np.errstate(over="ignore"):  # 2*eb overflows float32
        _declines("sz/delta", lambda: de.sz_encode_device(x, 1e39))
    # codes past the float32-exact range, and non-finite values
    _declines("sz/code_range", lambda: de.sz_encode_device(x * 1e7, 1e-3))
    nan = x.clone()
    nan[3, 3] = float("nan")
    _declines("sz/code_range", lambda: de.sz_encode_device(nan, 0.1))
    assert r_de.sz_encode_device(nan.numpy(), 0.1) is None
    monkeypatch.setattr(de, "_MAX_STREAM_BITS", 100)
    _declines("sz/stream_bits", lambda: de.sz_encode_device(x, 0.01))
    monkeypatch.undo()
    monkeypatch.setattr(pack, "arena_words", lambda nbits, min_words=64: 1)
    _declines("sz/arena", lambda: de.sz_encode_device(x, 0.01))


def test_zfp_guards_return_none_and_count(monkeypatch):
    x = torch.from_numpy(_field((32, 32), "walk", 2))
    _declines("zfp/empty_or_bound", lambda: de.zfp_encode_device(torch.zeros(0, 4), 0.1))
    _declines("zfp/empty_or_bound", lambda: de.zfp_encode_device(x, -1.0))
    _declines("zfp/empty_or_bound", lambda: de.zfp_encode_device(x, float("inf")))
    _declines("zfp/step_range", lambda: de.zfp_encode_device(x, 1e200))
    _declines("zfp/code_range", lambda: de.zfp_encode_device(x, 1e-9))
    assert r_de.zfp_encode_device(x.numpy(), 1e-9) is None
    monkeypatch.setattr(de, "_MAX_STREAM_BITS", 100)
    _declines("zfp/stream_bits", lambda: de.zfp_encode_device(x, 0.01))
    monkeypatch.undo()
    # a model-sized arena too small for the emission: bits dropped -> None
    monkeypatch.setattr(pack, "arena_words", lambda nbits, min_words=64: 1)
    _declines("zfp/arena", lambda: de.zfp_encode_device(x, 0.01))


def test_declined_field_takes_the_host_coder():
    x = (_field((40, 40), "walk", 3) * 1e7).astype(np.float32)
    sel = selector.Selection("sz", 1e-3, 1e-3, 1.0, 2.0, 0.0, float(x.max() - x.min()), 0.05)
    before = sum(de.DECLINES.values())
    cf = selector.encode_with_selection(x, sel, device_encode=True, device="cpu")
    assert sum(de.DECLINES.values()) == before + 1
    assert cf.codec == "raw" or cf.data[:4] == b"SZJ1"  # host container, or raw safety net


def test_encode_field_device_dispatch():
    x = torch.from_numpy(_field((32, 32), "smooth", 4))
    sel = selector.Selection("sz", 0.01, 0.005, 1.0, 2.0, 0.0, 1.0, 0.05)
    assert de.encode_field_device(x, sel) == de.sz_encode_device(x, 0.005)
    sel.codec = "zfp"
    assert de.encode_field_device(x, sel) == de.zfp_encode_device(x, 0.01)
    sel.codec = "raw"
    assert de.encode_field_device(x, sel) is None


class _WideTensors(TorchDispatchMode):
    """Records every int64 or float64 tensor an op returns that holds at
    least `limit` values (other than the arena of `skip` words)."""

    def __init__(self, limit, skip):
        super().__init__()
        self.limit, self.skip, self.seen = limit, skip, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.dtype in (torch.int64, torch.float64)
                    and t.numel() >= self.limit and tuple(t.shape) != (self.skip,)):
                self.seen.append((str(func), tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("shape,rel", [((96, 80), 1e-3), ((24, 40, 32), 1e-3),
                                       ((16, 20, 24), 1e-5)])
def test_zfp_emitter_holds_no_wide_block_tensor(monkeypatch, shape, rel):
    """The plane emitter keeps the reference's types: magnitudes int32, bit
    lengths and ranks int8, chunk values in 32 bits. No op of the ZFP device
    encode returns an int64 or float64 tensor of (blocks x 4^nd) values or
    more, apart from the word arena; the stream stays the reference's."""
    x = torch.from_numpy(_field(shape, "walk", 8))
    eb = _eb(x.numpy(), rel)
    arena = []
    real = pack.arena_words
    monkeypatch.setattr(pack, "arena_words", lambda *a: arena.append(real(*a)) or arena[-1])
    want = r_de.zfp_encode_device(x.numpy(), eb)
    nvals = int(np.prod([s + (-s) % 4 for s in shape]))
    de.zfp_encode_device(x, eb)  # sizes the arena
    with _WideTensors(nvals, arena[-1]) as mode:
        got = de.zfp_encode_device(x, eb)
    assert got is not None and got == want
    assert mode.seen == []
