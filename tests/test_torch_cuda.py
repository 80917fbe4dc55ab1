"""The port on the card: each CUDA kernel against its plain version, the
main path and the KV page tier on the GPU against the same paths on the
CPU.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere. The file
imports neither JAX nor the reference package, so it runs on a machine that
has only PyTorch (the reference comparisons live in the other
`test_torch_*.py` files, which run on the CPU):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core import Policy, compress, decompress, encode_with_selection, select
from repro_torch.core import device_encode as de
from repro_torch.core.decision_cache import DecisionCache
from repro_torch.kernels import _build, bot4, lorenzo, ops, ref
from repro_torch.runtime import kvcomp

pytestmark = pytest.mark.cuda

SHAPES = [(300, 517), (8, 128), (4, 40), (7, 64, 64), (4, 4, 129)]
EB_REL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _kernel_name(ndim):
    return "lorenzo2d_encode" if ndim == 2 else "lorenzo3d_encode"


def _launch_and_compare(x, eb, dev):
    name = _kernel_name(x.ndim)
    xt = torch.from_numpy(x).to(dev)
    before = lorenzo.LAUNCHES[name]
    got = getattr(lorenzo, name)(xt, eb)
    torch.cuda.synchronize()
    assert lorenzo.LAUNCHES[name] == before + 1
    assert got.device == xt.device and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), ref.lorenzo_encode_ref(xt, eb).cpu().numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_plain_version(cuda_device, shape):
    x = _field(shape, 4)
    _launch_and_compare(x, 1e-3 * float(x.max() - x.min()), cuda_device)


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_half_bin_ties(cuda_device, shape):
    """Values exactly at (k + 0.5) * delta round half to even on the card."""
    eb = 2.0**-7
    k = np.random.default_rng(1).integers(-1000, 1000, size=shape)
    _launch_and_compare(((k + 0.5) * 2 * eb).astype(np.float32), eb, cuda_device)


def _lorenzo_runs():
    """The run and strip sizes of `csrc/lorenzo.cu` (kRun2D rows per warp
    in K1; kRows3D rows and kRun3D planes per warp in K2)."""
    src = _build.SOURCES["lorenzo"].read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kRun2D", "kRows3D", "kRun3D")}


def _encode_edge_shapes(ndim):
    """Every width residue mod 4 on either side of a 128-column lane strip,
    a wide row, and heights (2-D) or depths and heights (3-D) on either
    side of the kernels' runs."""
    runs = _lorenzo_runs()
    widths = (127, 128, 129, 130, 131)
    if ndim == 2:
        r = runs["kRun2D"]
        return [(5, w) for w in widths] + [(3, 4097)] + [(h, 132) for h in (r - 1, r, r + 1)]
    z, h = runs["kRun3D"], runs["kRows3D"]
    return ([(3, 5, w) for w in widths] + [(2, 3, 4097)]
            + [(d, 5, 128) for d in (z - 1, z, z + 1)] + [(3, y, 132) for y in (h - 1, h, h + 1)])


def _edge_values(shape, kind, seed):
    """(x, eb): codes beyond 2^24 or beyond int32 at eb 0.5, or a walk with
    +inf, -inf and NaN on the first and last rows and columns and inside."""
    rng = np.random.default_rng(seed)
    if kind == "beyond_2p24":
        return rng.normal(0.0, 3e7, shape).astype(np.float32), 0.5
    if kind == "beyond_int32":
        return rng.normal(0.0, 1e9, shape).astype(np.float32), 0.5
    x = _field(shape, seed)
    spots = [tuple(0 for _ in shape), tuple(s - 1 for s in shape)]
    spots += [tuple(int(rng.integers(0, s)) if a != axis else e for a, s in enumerate(shape))
              for axis in range(len(shape)) for e in (0, shape[axis] - 1)]
    spots += [tuple(int(rng.integers(0, s)) for s in shape) for _ in range(4)]
    for i, spot in enumerate(spots):
        x[spot] = (np.inf, -np.inf, np.nan)[i % 3]
    finite = x[np.isfinite(x)]
    return x, 1e-3 * float(finite.max() - finite.min())


def _unaligned(xt):
    """xt's values at a 4-byte offset into a buffer (not 16-byte aligned)."""
    buf = torch.empty(xt.numel() + 1, dtype=xt.dtype, device=xt.device)
    view = buf[1:].view(xt.shape)
    view.copy_(xt)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("kind", ["beyond_2p24", "beyond_int32", "non_finite"])
def test_cuda_encode_edges_match_plain_version(cuda_device, ndim, kind):
    """K1/K2 exact against the plain version at their design's edges: the
    width residues around a lane strip, runs cut short and just over, codes
    past 2^24 and past int32, +-inf and NaN; aligned and unaligned."""
    name = _kernel_name(ndim)
    for i, shape in enumerate(_encode_edge_shapes(ndim)):
        x, eb = _edge_values(shape, kind, 20 + i)
        xt = torch.from_numpy(x).to(cuda_device)
        for t in (xt, _unaligned(xt)):
            got = getattr(lorenzo, name)(t, eb)
            want = ref.lorenzo_encode_ref(t, eb)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shape, kind, t.data_ptr() % 16)


@pytest.mark.parametrize("shape", SHAPES + [(1800, 3600), (2, 3, 4097)])
def test_cuda_encode_unaligned_base(cuda_device, shape):
    """A view at a 4-byte offset takes the scalar body: exact, and launched."""
    x = _field(shape, 11)
    eb = 1e-3 * float(x.max() - x.min())
    xt = _unaligned(torch.from_numpy(x).to(cuda_device))
    name = _kernel_name(len(shape))
    before = lorenzo.LAUNCHES[name]
    got = getattr(lorenzo, name)(xt, eb)
    torch.cuda.synchronize()
    assert lorenzo.LAUNCHES[name] == before + 1
    assert torch.equal(got, ref.lorenzo_encode_ref(xt, eb))


@pytest.mark.parametrize("name,ndim", [("lorenzo2d_encode", 2), ("lorenzo3d_encode", 3)])
def test_cuda_wrapper_rejects_bad_inputs(cuda_device, name, ndim):
    kernel = getattr(lorenzo, name)
    good = torch.zeros((8,) * ndim, device=cuda_device)
    with pytest.raises(TypeError):
        kernel(good.double(), 0.1)
    with pytest.raises(ValueError):
        kernel(good.transpose(0, 1), 0.1)


# large enough that SZ stays below 32 bits/value also where zstandard is
# missing and the Huffman table costs 40 bits a symbol
@pytest.mark.parametrize("shape", [(64, 96), (16, 48, 48)])
@pytest.mark.parametrize("codecs", [("sz", "raw"), ("zfp", "raw")])
def test_main_path_on_card_equals_cpu(cuda_device, shape, codecs):
    """The same decision gives the same container bytes on the card and on
    the CPU, with no device-encode decline; SZ fields launch their kernel,
    and the card's own compress + decompress honours eb_abs."""
    x = _field(shape, 2)
    sel = select(x, eb_rel=EB_REL, codecs=codecs, device="cpu")
    assert sel.codec == codecs[0]
    name = _kernel_name(len(shape))
    launches, declines = lorenzo.LAUNCHES[name], sum(de.DECLINES.values())
    on_card = encode_with_selection(x, sel, device_encode=True, device=cuda_device)
    assert lorenzo.LAUNCHES[name] == launches + (sel.codec == "sz")
    on_cpu = encode_with_selection(x, sel, device_encode=True, device="cpu")
    assert on_card.data == on_cpu.data
    assert sum(de.DECLINES.values()) == declines
    cf = compress(x, Policy.fixed_accuracy(eb_rel=EB_REL, codecs=codecs),
                  device_encode=True, device=cuda_device)
    out = decompress(cf, device=cuda_device)
    assert out.device.type == cuda_device.type and tuple(out.shape) == shape
    assert float((out.cpu() - torch.from_numpy(x)).abs().max()) <= cf.selection.eb_abs


def pow2_max_field(shape, seed):
    """Every 4-block's largest magnitude an exact power of two (the knife
    edge of ceil(log2 max|b|)), signs mixed, ragged edges included."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    grid = tuple(-(-s // 4) for s in shape)
    k = rng.integers(-6, 7, size=grid)
    scale = np.ldexp(1.0, k)
    for axis in range(len(shape)):
        scale = np.repeat(scale, 4, axis=axis)
    scale = scale[tuple(slice(0, s) for s in shape)]
    x = x * scale
    corner = tuple(slice(0, None, 4) for _ in shape)
    x[corner] = np.sign(x[corner] + 0.5) * scale[corner]
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_dequantize_matches_plain_version(cuda_device, shape):
    """K3/K4: exact against float32(k) * 2eb, through ops.lorenzo_decode."""
    x = _field(shape, 5)
    eb = 1e-3 * float(x.max() - x.min())
    name = "dequantize2d" if len(shape) == 2 else "dequantize3d"
    d = ops.lorenzo_encode(torch.from_numpy(x).to(cuda_device), eb)
    before = lorenzo.LAUNCHES[name]
    got = ops.lorenzo_decode(d, eb)
    torch.cuda.synchronize()
    assert lorenzo.LAUNCHES[name] == before + 1
    want = ref.lorenzo_decode_ref(d, eb)
    assert got.dtype == torch.float32 and got.device == d.device
    assert torch.equal(got, want)
    k = torch.randint(-(2**30), 2**30, shape, dtype=torch.int32, device=cuda_device)
    assert torch.equal(getattr(lorenzo, name)(k, eb), ref.dequantize_ref(k, eb))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("transform", ["zfp", "hwt", "dct2"])
@pytest.mark.parametrize("kind", ["walk", "pow2max"])
def test_cuda_bot_matches_plain_version(cuda_device, shape, transform, kind):
    """K5/K6: bits equal and recon bit for bit to the plain version (they
    take the same float32 steps in the same order)."""
    x = _field(shape, 6) if kind == "walk" else pow2_max_field(shape, 6)
    eb = 1e-3 * float(x.max() - x.min())
    name = "bot2d_fused" if len(shape) == 2 else "bot3d_fused"
    xt = torch.from_numpy(x).to(cuda_device)
    before = bot4.LAUNCHES[name]
    recon, bits = ops.bot_fused(xt, eb, transform)
    torch.cuda.synchronize()
    assert bot4.LAUNCHES[name] == before + 1
    want_r, want_b = ref.bot_fused_ref(xt, eb, transform)
    assert bits.shape == want_b.shape == tuple(-(-s // 4) for s in shape)
    assert torch.equal(bits, want_b)
    assert _same_bits(recon, want_r)
    assert float((recon.cpu() - torch.from_numpy(x)).abs().max()) <= eb


def _same_bits(a, b):
    """Equal bit for bit (so -0.0 differs from 0.0), any NaN equal to any NaN."""
    a, b = (torch.where(t.isnan(), float("nan"), t).view(torch.int32) for t in (a, b))
    return torch.equal(a, b)


def edge_field(shape, kind, seed):
    """A uniform field in which about half the 4-blocks (the first always)
    hold one edge of the BOT kernels' arithmetic: "big", maxima in
    (2^127, FLT_MAX] (e = 128; FLT_MAX itself in the first block); "tiny",
    magnitudes from 1e-30 down into the subnormals (the 1e-30 floor of the
    block max); "zero", all zeros; "inf", "-inf", "nan", that value first
    in the block."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    pick = rng.random(tuple(-(-s // 4) for s in shape)) < 0.5
    pick.flat[0] = True
    mask = pick
    for axis in range(len(shape)):
        mask = np.repeat(mask, 4, axis=axis)
    mask = mask[tuple(slice(0, s) for s in shape)]
    if kind == "big":
        x = np.where(mask, x * (1.99 * 2.0**127), x)
        x[(0,) * len(shape)] = np.finfo(np.float32).max
    elif kind == "tiny":
        x = np.where(mask, x * 10.0 ** rng.uniform(-45.0, -30.0, shape), x)
    elif kind == "zero":
        x = np.where(mask, 0.0, x)
    else:
        corner = tuple(slice(0, None, 4) for _ in shape)
        x[corner] = np.where(pick, float(kind), x[corner])
    return x.astype(np.float32)


# every residue mod 4 on each axis, for K5 and for K6
EDGE_SHAPES = [(300, 517), (301, 518), (302, 519), (303, 516),
               (5, 6, 7), (6, 7, 4), (7, 5, 6), (4, 4, 129)]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["big", "tiny", "zero", "inf", "-inf", "nan"])
def test_cuda_bot_edges_match_plain_version(cuda_device, shape, kind):
    """K5/K6 at the edges of their exact power-of-two arithmetic: bits equal
    and recon bit for bit to the plain version, for zfp, hwt and dct2, under
    a usual bound, one that makes coefficients m >= 2^24, 1e-25 (raw clamps
    to 2^-60 on O(1) blocks), 1e-37 (tiny blocks reconstruct into the
    subnormals) and 1e30 (raw overflows to inf on zero and tiny blocks)."""
    x = edge_field(shape, kind, 9)
    fin = x[np.isfinite(x)].astype(np.float64)
    r = float(fin.max() - fin.min())
    name = "bot2d_fused" if len(shape) == 2 else "bot3d_fused"
    xt = torch.from_numpy(x).to(cuda_device)
    before = bot4.LAUNCHES[name]
    for transform in ("zfp", "hwt", "dct2"):
        for eb in (1e-3 * r, 1e-9 * r, 1e-25, 1e-37, 1e30):
            recon, bits = ops.bot_fused(xt, eb, transform)
            want_r, want_b = ref.bot_fused_ref(xt, eb, transform)
            assert torch.equal(bits, want_b), (transform, eb)
            assert _same_bits(recon, want_r), (transform, eb)
    assert bot4.LAUNCHES[name] == before + 15


@pytest.mark.parametrize("name,ndim", [("bot2d_fused", 2), ("bot3d_fused", 3),
                                       ("dequantize2d", 2), ("dequantize3d", 3)])
def test_cuda_new_wrappers_reject_bad_inputs(cuda_device, name, ndim):
    kernel = getattr(bot4, name, None) or getattr(lorenzo, name)
    dtype = torch.float32 if name.startswith("bot") else torch.int32
    good = torch.zeros((8,) * ndim, dtype=dtype, device=cuda_device)
    with pytest.raises(TypeError):
        kernel(good.double(), 0.1)  # wrong dtype
    with pytest.raises(ValueError):
        kernel(good.transpose(0, 1), 0.1)  # not contiguous
    with pytest.raises(ValueError):
        kernel(torch.zeros((8,) * (ndim + 1), dtype=dtype, device=cuda_device), 0.1)


def _kv_stack(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), axis=-2) * np.exp(rng.standard_normal(shape[-1]))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("shape", [(4, 16, 256), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fixed_ratio", "fixed_accuracy", "raw", "device_encode"])
def test_cuda_compress_page_equals_cpu(cuda_device, shape, dtype, mode):
    """compress_page / decompress_page on the card give the CPU port's
    codec, bound, byte count and payload; the restore honours eb."""
    page = _kv_stack(shape, 7, dtype)
    pol = {"fixed_ratio": Policy.fixed_ratio(8.0), "device_encode": Policy.fixed_ratio(8.0),
           "fixed_accuracy": Policy.fixed_accuracy(eb_rel=1e-2), "raw": Policy.raw()}[mode]
    kw = dict(device_encode=mode == "device_encode")
    on_cpu = kvcomp.compress_page(page, pol, device="cpu", **kw)
    name = "bot2d_fused" if len(shape) == 2 else "bot3d_fused"
    before = bot4.LAUNCHES[name]
    on_card = kvcomp.compress_page(page.to(cuda_device), pol, device=cuda_device, **kw)
    assert bot4.LAUNCHES[name] == before + (on_card.codec == "bot")
    for k in ("codec", "shape", "dtype", "nbytes", "eb"):
        assert getattr(on_card, k) == getattr(on_cpu, k), k
    back = kvcomp.decompress_page(on_card, device=cuda_device)
    assert back.device.type == "cuda" and back.dtype == dtype and tuple(back.shape) == shape
    if on_card.codec in ("raw", "zfp"):
        assert on_card.payload == on_cpu.payload
    else:
        tol = 1e-5 * float(page.float().abs().max())
        assert float((on_card.payload.float() - on_cpu.payload.float()).abs().max()) <= tol
    if on_card.codec == "raw":
        assert torch.equal(back.cpu(), page)
    else:
        rel = 2.0**-8 if dtype == torch.bfloat16 else 0.0
        err = (back.float().cpu() - page.float()).abs()
        assert bool((err <= on_card.eb + rel * back.float().cpu().abs() + 1e-6).all())


def test_cuda_page_cache_replays_on_card(cuda_device):
    page = _kv_stack((4, 16, 256), 8, torch.bfloat16).to(cuda_device)
    cache, pol = DecisionCache(), Policy.fixed_ratio(8.0)
    a = kvcomp.compress_page(page, pol, cache=cache, name="kv/long/0/k0", device=cuda_device)
    assert cache.events["kv/long/0/k0"] == "miss"
    b = kvcomp.compress_page(page, pol, cache=cache, name="kv/long/0/k0", device=cuda_device)
    assert cache.events["kv/long/0/k0"] == "hit"
    assert (a.eb, a.nbytes) == (b.eb, b.nbytes)


def _pytree_fields():
    from benchmarks.common import atm_suite, hurricane_suite

    fields = dict(atm_suite(4, size=(96, 192)))
    fields.update(hurricane_suite(3, size=(16, 48, 48)))
    fields["walk1d"] = _field((4096,), 7)
    fields["const"] = np.full((64, 64), 2.0, np.float32)
    return fields


def _close_decisions(got, want):
    for g, w in zip(got, want):
        assert g.codec == w.codec
        assert g.eb_sz == pytest.approx(w.eb_sz, rel=1e-5)
        assert g.br_sz == pytest.approx(w.br_sz, abs=5e-3)
        assert g.br_zfp == pytest.approx(w.br_zfp, abs=5e-3)


@pytest.mark.parametrize("rel", [1e-3, 1e-4])
def test_select_many_on_card_equals_cpu(cuda_device, rel):
    """The batched decisions on the card within the golden tolerances of the
    port's on the CPU, and of the card's own per-field `select`."""
    from repro_torch.core import select_many

    arrs = list(_pytree_fields().values())
    on_card = select_many(arrs, eb_rel=rel, device=cuda_device)
    _close_decisions(on_card, select_many(arrs, eb_rel=rel, device="cpu"))
    _close_decisions(on_card, [select(x, eb_rel=rel, device=cuda_device) for x in arrs])


def _mixed_tree():
    rng = np.random.default_rng(11)
    fields = _pytree_fields()
    return {
        "f": fields,
        "deep": np.cumsum(rng.standard_normal((2, 3, 8, 32, 32)), -1).astype(np.float32),
        "f64": np.cumsum(rng.standard_normal((64, 64)), 0),
        "f16": np.cumsum(rng.standard_normal((48, 48)), 1).astype(np.float16),
        "bf16": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)).to(torch.bfloat16),
        "ids": rng.integers(0, 1000, (128,)).astype(np.int32),
        "mask": rng.integers(0, 2, (16, 16)).astype(bool),
        "lr": 3e-4,
        "card": torch.from_numpy(_field((40, 40), 12)).to("cuda"),
    }


def test_compress_pytree_on_card_equals_cpu(cuda_device):
    """`compress_pytree(device_encode=True)` on the card: decisions within
    the golden tolerances of the CPU's and the same bytes where the decision
    is the same; K1/K2 launched once per 2-D/3-D SZ leaf, from the encoder
    threads, with no decline; a serial compress gives the same bytes; the
    decoded tree on the card within each leaf's bound, raw leaves bit for
    bit."""
    from repro_torch.core import Policy, compress_pytree, decompress_pytree

    tree = _mixed_tree()
    pol = Policy.fixed_accuracy(eb_rel=EB_REL)
    lorenzo.reset_launches()
    declines = sum(de.DECLINES.values())
    ct = compress_pytree(tree, pol, device_encode=True, device=cuda_device)
    launches = dict(lorenzo.LAUNCHES)
    assert sum(de.DECLINES.values()) == declines
    views = {name: cf.shape for name, cf in ct.fields.items()}
    sz2 = sum(1 for n, cf in ct.fields.items() if cf.codec == "sz" and len(_folded(views[n])) == 2)
    sz3 = sum(1 for n, cf in ct.fields.items() if cf.codec == "sz" and len(_folded(views[n])) == 3)
    assert sz2 >= 1 and sz3 >= 1
    assert launches["lorenzo2d_encode"] == sz2 and launches["lorenzo3d_encode"] == sz3
    cpu_tree = dict(tree, card=tree["card"].cpu())
    on_cpu = compress_pytree(cpu_tree, pol, device_encode=True, device="cpu")
    assert list(on_cpu.fields) == list(ct.fields)
    for name, cf in ct.fields.items():
        other = on_cpu.fields[name]
        assert (cf.codec, cf.dtype, cf.shape) == (other.codec, other.dtype, other.shape), name
        if cf.selection is None or other.selection == cf.selection:
            assert cf.data == other.data, name
        else:
            _close_decisions([cf.selection], [other.selection])
    serial = compress_pytree(tree, pol, device_encode=True, device=cuda_device, workers=0)
    assert {k: v.data for k, v in serial.fields.items()} == {k: v.data for k, v in ct.fields.items()}
    out = decompress_pytree(ct, device=cuda_device)
    assert out["bf16"].device.type == "cuda" and out["bf16"].dtype == torch.bfloat16
    assert torch.equal(out["bf16"].cpu().view(torch.int16), tree["bf16"].view(torch.int16))
    assert torch.equal(out["ids"].cpu(), torch.from_numpy(tree["ids"]))
    for name, x in tree["f"].items():
        y = out["f"][name].cpu().numpy()
        eb = ct.fields[f"f/{name}"].selection.eb_abs
        assert np.abs(y.astype(np.float64) - x).max() <= eb + 4 * np.spacing(np.abs(x).max()), name


def _folded(shape):
    from repro_torch.core.selector import _fold_ndim

    return tuple(_fold_ndim(np.empty(shape, np.uint8)).shape)


#: the ZFP device encode's peak on the 100x500x500 HUR_QICE_0 field before its
#: (blocks x 64) tensors were narrowed to the reference's types (PERF.md:
#: `peak_gib` of `chip_smoke.py`'s main path, NVIDIA H100 80GB HBM3)
ZFP_PEAK_GIB_BEFORE = 6.90


def test_zfp_encode_peak_below_the_wide_emitter(cuda_device):
    from benchmarks.common import hurricane_suite

    x = torch.from_numpy(hurricane_suite(1, size=(100, 500, 500))["QICE_0"]).to(cuda_device)
    sel = select(x, eb_rel=1e-4, device=cuda_device)
    assert sel.codec == "zfp"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf = compress(x, Policy.fixed_accuracy(eb_rel=1e-4), device_encode=True, device=cuda_device)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert cf.codec == "zfp"
    assert peak < ZFP_PEAK_GIB_BEFORE, peak


TARGET_POLICIES = {
    "psnr60": Policy.fixed_psnr(60.0),
    "ratio8": Policy.fixed_ratio(8.0),
    "ssim0.97": Policy.fixed_ssim(0.97),
    "corr0.995": Policy.fixed_correlation(0.995),
    "ks0.1": Policy.fixed_ks(0.1),
    "psnr60-zfp": Policy.fixed_psnr(60.0, codecs=("zfp",)),
}


@pytest.mark.parametrize("mode_id", list(TARGET_POLICIES))
def test_solve_many_on_card_equals_cpu(cuda_device, mode_id):
    """The quality-target solve on the card against the port's own on the
    CPU: codec and on_target equal, eb to 1e-4 relative, est_bitrate to
    5e-3 bits/value (the tolerances of the CPU parity suite)."""
    from repro_torch.core import solve_many

    arrs = list(_pytree_fields().values())
    pol = TARGET_POLICIES[mode_id]
    on_card = solve_many(arrs, pol, device=cuda_device)
    on_cpu = solve_many(arrs, pol, device="cpu")
    for g, w in zip(on_card, on_cpu):
        assert (g.selection.codec, g.on_target) == (w.selection.codec, w.on_target)
        assert g.selection.eb_abs == pytest.approx(w.selection.eb_abs, rel=1e-4)
        assert g.selection.eb_sz == pytest.approx(w.selection.eb_sz, rel=1e-4)
        assert g.est_bitrate == pytest.approx(w.est_bitrate, abs=5e-3)
        if w.est_metric is not None:
            assert g.est_metric == pytest.approx(w.est_metric, abs=1e-4)


def _psnr(x, y):
    x = np.asarray(x, np.float64)
    mse = float(np.mean((x - np.asarray(y, np.float64).reshape(x.shape)) ** 2))
    return 10.0 * np.log10(float(x.max() - x.min()) ** 2 / mse)


@pytest.mark.parametrize("shape", [(384, 768), (32, 96, 96)])
def test_compress_fixed_psnr_on_card(cuda_device, shape):
    """`compress(x, Policy.fixed_psnr(60), device_encode=True)` on the card:
    the SZ field's codes come from K1 (2-D) or K2 (3-D), the decision is the
    CPU's, and the decoded field lands within 1 dB of 60 dB."""
    from benchmarks.common import atm_suite, hurricane_suite

    x = (next(iter(atm_suite(1, size=shape).values())) if len(shape) == 2
         else hurricane_suite(3, size=shape)["U_2"])
    pol = Policy.fixed_psnr(60.0)
    lorenzo.reset_launches()
    cf = compress(x, pol, device_encode=True, device=cuda_device)
    torch.cuda.synchronize()
    assert cf.codec == "sz"
    assert lorenzo.LAUNCHES[_kernel_name(len(shape))] == 1
    cpu = compress(x, pol, device_encode=True, device="cpu")
    assert cpu.codec == cf.codec
    assert cpu.selection.eb_sz == pytest.approx(cf.selection.eb_sz, rel=1e-4)
    y = decompress(cf, device=cuda_device)
    assert y.device.type == "cuda"
    assert abs(_psnr(x, y.cpu().numpy()) - 60.0) <= 1.0


def _warm_steps(fields):
    """The golden warm trajectory's three steps: cold, identical, and the
    first field times 1000 with the second nudged by one ulp."""
    names = list(fields)
    jumped = dict(fields)
    jumped[names[0]] = fields[names[0]] * 1000.0
    nudged = fields[names[1]].copy()
    nudged.flat[0] = np.nextafter(nudged.flat[0], np.float32(np.inf))
    jumped[names[1]] = nudged
    return names, [fields, fields, jumped]


@pytest.mark.parametrize("solver", ["select_many", "solve_many"])
def test_warm_path_on_card_equals_cpu(cuda_device, solver):
    """`select_many` / `solve_many(fixed_ratio(8))` with a `DecisionCache`
    on the card, three steps: the events equal the CPU's at every step
    (the fingerprints digest the same sampled blocks), the card's warm
    decisions equal its cold ones bit for bit, and each agrees with the
    CPU's within the golden tolerances."""
    from repro_torch.core import select_many, solve_many

    names, steps = _warm_steps(_pytree_fields())

    def run(fields, cache, dev):
        arrs = list(fields.values())
        if solver == "select_many":
            return select_many(arrs, eb_rel=1e-4, cache=cache, names=names, device=dev)
        sols = solve_many(arrs, Policy.fixed_ratio(8.0), cache=cache, names=names, device=dev)
        return [s.selection for s in sols]

    card, cpu = DecisionCache(), DecisionCache()
    out = []
    for fields in steps:
        card.reset_stats()
        cpu.reset_stats()
        got, want = run(fields, card, cuda_device), run(fields, cpu, "cpu")
        assert card.events == cpu.events
        _close_decisions(got, want)
        out.append(got)
    assert out[1] == out[0]
    assert card.events[names[0]] == card.events[names[1]] == "invalidated"
    assert {e["fingerprint"]["digest"] for e in card.to_manifest()["entries"]} == {
        e["fingerprint"]["digest"] for e in cpu.to_manifest()["entries"]}


def _ckpt_tree():
    rng = np.random.default_rng(13)
    fields = _pytree_fields()
    return {
        "f": fields,
        "f64": np.cumsum(rng.standard_normal((64, 64)), 0),
        "bf16": torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)).to(torch.bfloat16),
        "ids": rng.integers(0, 1000, (128,)).astype(np.int32),
        "lr": 3e-4,
        "card": torch.from_numpy(_field((40, 40), 12)).to("cuda"),
    }


def _rows(path):
    import json

    with open(f"{path}/manifest.json") as f:
        rows = json.load(f)["fields"]
    with open(f"{path}/data.bin", "rb") as f:
        blob = f.read()
    return {r["name"]: (r, blob[r["offset"]:r["offset"] + r["nbytes"]]) for r in rows}


@pytest.mark.parametrize("device_encode", [False, True])
def test_checkpoint_on_card_equals_cpu(cuda_device, tmp_path, device_encode):
    """A `CheckpointManager` save on the card against the same save on the
    CPU: the same rows and bounds, decisions within the golden tolerances
    (the card's float32 reductions round the estimated rates otherwise),
    and the same bytes for every field whose bounds are the same, so the
    same `data.bin` when all are; K1/K2 launched by the device encode;
    `restore` on the card within each field's bound, raw leaves bit for
    bit; a warm save all hits."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

    tree = _ckpt_tree()
    cfg = dict(policy=Policy.fixed_accuracy(eb_rel=EB_REL), cache=True, device_encode=device_encode)
    card = CheckpointManager(CheckpointConfig(str(tmp_path / "card"), **cfg), device=cuda_device)
    lorenzo.reset_launches()
    path = card.save(0, tree)
    launches = dict(lorenzo.LAUNCHES)
    cpu_tree = dict(tree, card=tree["card"].cpu())
    other = CheckpointManager(CheckpointConfig(str(tmp_path / "cpu"), **cfg), device="cpu")
    got, want = _rows(path), _rows(other.save(0, cpu_tree))
    assert list(got) == list(want)
    for name, (row, data) in got.items():
        wrow, wdata = want[name]
        assert (row["codec"], row["dtype"], row["shape"], row["eb"]) == (
            wrow["codec"], wrow["dtype"], wrow["shape"], wrow["eb"]), name
        entry, wentry = card.cache.entries.get(name), other.cache.entries.get(name)
        if entry is None:
            assert data == wdata, name  # raw rows
            continue
        _close_decisions([entry.to_selection()], [wentry.to_selection()])
        if entry.selection["eb_sz"] == wentry.selection["eb_sz"]:
            # the stream is a function of the codec and the bounds only
            assert data == wdata, name
    # K1/K2 encode the 2-D and 3-D SZ fields (a 1-D field's codes are torch ops)
    n_sz = sum(1 for r, _ in got.values()
               if r["codec"] == "sz" and len(_folded(tuple(r["shape"]))) > 1)
    k12 = launches["lorenzo2d_encode"] + launches["lorenzo3d_encode"]
    assert k12 == (n_sz if device_encode else 0)
    step, flat = card.restore()
    assert step == 0
    for name, (row, _) in got.items():
        y = flat[name]
        assert y.device.type == "cuda", name
        if row["codec"] in ("sz", "zfp"):
            x = tree["f"][name.split("/", 1)[1]] if name.startswith("f/") else (
                tree["f64"] if name == "f64" else tree["card"].cpu().numpy())
            err = float((y.double().cpu() - torch.as_tensor(np.asarray(x), dtype=torch.float64)).abs().max())
            assert err <= row["eb"], name
    assert torch.equal(flat["bf16"].cpu().view(torch.int16), tree["bf16"].view(torch.int16))
    assert torch.equal(flat["ids"].cpu(), torch.from_numpy(tree["ids"]))
    card.cache.reset_stats()
    card.save(1, tree)
    assert card.cache.stats()["hits"] == len(card.cache.entries) > 0


def test_async_save_on_card_snapshots_at_the_call(cuda_device, tmp_path):
    """A card tensor overwritten in place right after `async_save` returns
    (on the same stream) is saved with its values at the call."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager

    x = _field((256, 512), 21)
    w = torch.from_numpy(x).to(cuda_device)
    mgr = CheckpointManager(CheckpointConfig(
        str(tmp_path), policy=Policy.fixed_accuracy(eb_rel=EB_REL), device_encode=True),
        device=cuda_device)
    mgr.async_save(0, {"w": w})
    w.mul_(1000.0)
    mgr.wait()
    _, flat = mgr.restore()
    (row, _), = _rows(f"{tmp_path}/step_000000000").values()
    assert float((flat["w"].double().cpu() - torch.from_numpy(x).double()).abs().max()) <= row["eb"]


# -- serving: the dense decoder and the paged batcher on the card -----------


def _serving_model(device, dtype="float32"):
    """The reduced 2-layer smollm-360m of the batcher tests, its weights
    drawn on the CPU from a seeded generator and copied to `device`."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn

    cfg = reduced_for_smoke(get_config("smollm-360m")).scaled(n_layers=2, dtype=dtype)
    cpu_model = build_model(cfg, device="cpu")
    params = mnn.init_tree(cpu_model.desc(), torch.Generator().manual_seed(0), device="cpu")
    if device.type == "cpu":
        return cfg, cpu_model, params
    return cfg, build_model(cfg, device=device), mnn.tree_map(lambda a: a.to(device), params)


def _serving_prompts(cfg, seed, n, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, length).astype(np.int32) for _ in range(n)]


def test_model_logits_on_card_equal_cpu(cuda_device):
    """float32 logits and loss of the forward without a cache on the card
    against the same weights on the CPU (TF32 off, so only the order of
    float32 sums differs): rtol 1e-4, atol 1e-5 * max|logit|."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model, params = _serving_model(cuda_device)
    _, cpu_model, cpu_params = _serving_model(torch.device("cpu"))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    ref, _ = cpu_model.forward(cpu_params, batch)
    got, _ = model.forward(params, {k: v.to(cuda_device) for k, v in batch.items()})
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5 * float(ref.abs().max()))
    loss = model.loss(params, {k: v.to(cuda_device) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(loss), float(cpu_model.loss(cpu_params, batch)[0]), rtol=1e-5)


def test_paged_decode_on_card_equals_single_stream(cuda_device):
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, model, params = _serving_model(cuda_device)
    b = ContinuousBatcher(model, params, slots=4, max_len=32, eos_id=-1, page_tokens=8)
    assert b.paged and b.cache["blocks"]["k"].device.type == "cuda"
    reqs = [Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(_serving_prompts(cfg, 5, 3, 8))]
    b.run(reqs)
    for r in reqs:
        cache = model.init_cache(1, 32)
        logits, cache = model.forward(
            params, {"tokens": torch.from_numpy(r.prompt)[None].to(cuda_device)}, cache)
        toks = [int(torch.argmax(logits[0, -1]))]
        for _ in range(5):
            lg, cache = model.forward(params, {"tokens": torch.tensor(
                [[toks[-1]]], dtype=torch.int32, device=cuda_device)}, cache)
            toks.append(int(torch.argmax(lg[0, -1])))
        assert r.out == toks, r.rid


def test_raw_evict_restore_on_card_is_invisible(cuda_device):
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, model, params = _serving_model(cuda_device)
    prompts = _serving_prompts(cfg, 6, 4, 12)

    def run(arena_pages):
        b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                              arena_pages=arena_pages, policies=Policy.raw())
        reqs = [Request(rid=i, prompt=p, max_new=20) for i, p in enumerate(prompts)]
        b.run(reqs)
        return reqs, b

    calm_reqs, calm = run(None)
    tight_reqs, tight = run(5)
    assert calm.stats["evictions"] == 0
    assert tight.stats["evictions"] > 0 and tight.stats["restores"] > 0
    assert [r.out for r in calm_reqs] == [r.out for r in tight_reqs]


def test_lossy_serving_on_card_launches_k6(cuda_device):
    """Long requests under `serving_policies(8)` evict their page stacks
    through K6 (one launch per lossy stack) and complete."""
    from repro_torch.core.policy import serving_policies
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, model, params = _serving_model(cuda_device, dtype="bfloat16")
    b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                          arena_pages=5, policies=serving_policies(8.0), long_threshold=24)
    reqs = [Request(rid=i, prompt=p, max_new=20) for i, p in enumerate(_serving_prompts(cfg, 6, 4, 12))]
    before = bot4.LAUNCHES["bot3d_fused"]
    b.run(reqs)
    assert all(r.done and len(r.out) == 20 and r.policy.mode == "fixed_ratio" for r in reqs)
    assert b.stats["evictions"] > 0 and b.stats["restores"] > 0
    lossy = sum(r.evictions for r in reqs)
    assert bot4.LAUNCHES["bot3d_fused"] - before >= lossy


# -- training: the train step, gradient compression and AdamW on the card ---


def _train_run(device, steps, gc):
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    cfg, model, params = _serving_model(device)
    state = init_opt_state(params, gc)
    step = make_train_step(model, AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5), gc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic_batch(dcfg, s).items()}
        params, state, m = step(params, state, batch)
        assert all(v.device.type == device.type for v in m.values())
        losses.append(float(m["loss"]))
    return losses, params


@pytest.mark.parametrize("compress_grads", [False, True])
def test_train_steps_on_card_track_cpu(cuda_device, compress_grads):
    """Five reduced float32 train steps from the same weights on the card
    and on the CPU: losses within a relative 1e-4 (float32 sums in other
    orders, amplified by Adam's normalized step and, with compression, by
    codes that flip where the two gradients straddle a rounding midpoint;
    tests/test_torch_train.py), params within 2 * sum(lr) + 1e-5 max|p|."""
    from repro_torch.optim import GradCompressConfig

    gc = GradCompressConfig(eb_rel=1e-3) if compress_grads else None
    got, gp = _train_run(cuda_device, 5, gc)
    want, wp = _train_run(torch.device("cpu"), 5, gc)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for a, b in zip(_tree_leaves(gp), _tree_leaves(wp)):
        assert a.device.type == "cuda"
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()) + 2 * 5 * 1e-3, err


def _tree_leaves(tree):
    from repro_torch.core import pytree

    return [leaf for _, leaf in pytree.flatten_with_path(tree)[0]]


def _grads_and_residuals(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": ((64, 33), 1e-6), "b": ((3, 17, 40), 10.0), "c": ((1000,), 0.1),
              "d": ((7, 13), 1.0), "const": ((4, 6), 0.0)}
    g = {k: torch.from_numpy((rng.standard_normal(s) * sc if sc else np.full(s, 0.375))
                             .astype(np.float32)) for k, (s, sc) in shapes.items()}
    r = {k: torch.from_numpy((rng.standard_normal(s) * 1e-3 * (sc or 1.0)).astype(np.float32))
         for k, (s, sc) in shapes.items()}
    return g, r


@pytest.mark.parametrize("eb_rel", [1e-3, 1e-4])
def test_grad_compress_on_card_equals_cpu(cuda_device, eb_rel):
    """The same gradients and residuals through `optim.compress` on both
    devices: dequantized gradients and residuals bit for bit (a true
    division, round half to even, the residual as one float64 FMA, exact
    integer histograms), wire bits within 1e-6."""
    from repro_torch.optim import compress as gcomp

    cfg = gcomp.GradCompressConfig(eb_rel=eb_rel)
    g, r = _grads_and_residuals(3)
    cq, cs, cm = gcomp.compress(cfg, g, {"residual": r})
    dq, ds, dm = gcomp.compress(cfg, {k: v.to(cuda_device) for k, v in g.items()},
                                {"residual": {k: v.to(cuda_device) for k, v in r.items()}})
    for k in g:
        assert dq[k].device.type == "cuda"
        assert torch.equal(dq[k].cpu(), cq[k]), k
        assert torch.equal(ds["residual"][k].cpu(), cs["residual"][k]), k
    np.testing.assert_allclose(float(dm["wire_bits_per_value"]), float(cm["wire_bits_per_value"]),
                               rtol=1e-6)


def test_adamw_update_on_card_tracks_cpu(cuda_device):
    """Three `adamw.update`s on the same tree on both devices: m and v
    within 1e-6 of each leaf's max, params within 1e-6 of max|p|, grad norm
    and lr within 1e-6 (the card's cos, pow and sum orders are not the
    CPU's)."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    rng = np.random.default_rng(5)
    p0 = {"w": torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32)),
          "n": torch.ones(40)}
    trees = {d: {k: v.clone().to(d) for k, v in p0.items()} for d in ("cpu", cuda_device)}
    states = {d: adamw.init(trees[d]) for d in trees}
    for s in range(3):
        g = {k: torch.from_numpy((rng.standard_normal(v.shape) * (2.0 if s else 1e-3))
                                 .astype(np.float32)) for k, v in p0.items()}
        out = {}
        for d in trees:
            trees[d], states[d], out[d] = adamw.update(
                cfg, {k: v.to(d) for k, v in g.items()}, states[d], trees[d])
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(out[cuda_device][key]), float(out["cpu"][key]),
                                       rtol=1e-6)
        for k in p0:
            for got, want in ((trees[cuda_device][k], trees["cpu"][k]),
                              (states[cuda_device]["m"][k], states["cpu"]["m"][k]),
                              (states[cuda_device]["v"][k], states["cpu"]["v"][k])):
                np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                           atol=1e-6 * float(want.abs().max()))
    assert int(states[cuda_device]["step"]) == 3
    assert states[cuda_device]["step"].dtype == torch.int32


# -- the MoE and MLA decoders on the card -----------------------------------

MOE_MLA = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


def _reduced_pair(name, device, moe=None, **over):
    """The reduced `name` at float32 (with `over`, and the MoE fields `moe`)
    on the CPU and on `device`, with the same weights drawn on the CPU from
    a seeded generator."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn

    cfg = reduced_for_smoke(get_config(name)).scaled(dtype="float32", **over)
    if moe:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, **moe))
    cpu = build_model(cfg, device="cpu")
    params = mnn.init_tree(cpu.desc(), torch.Generator().manual_seed(0), device="cpu")
    return cfg, cpu, params, build_model(cfg, device=device), mnn.tree_map(
        lambda a: a.to(device), params)


@pytest.mark.parametrize("name", MOE_MLA)
def test_moe_mla_logits_on_card_equal_cpu(cuda_device, name):
    """float32 logits and loss of the forward without a cache (MoE routing,
    deepseek's dense layer and parallel MLA path) on the card against the
    CPU, TF32 off: rtol 1e-4, atol 1e-5 * max|logit|; loss to rtol 1e-5."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, cparams, card, params = _reduced_pair(name, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    want, _ = cpu.forward(cparams, batch)
    got, _ = card.forward(params, {k: v.to(cuda_device) for k, v in batch.items()})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    loss = card.loss(params, {k: v.to(cuda_device) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(loss), float(cpu.loss(cparams, batch)[0]), rtol=1e-5)


@pytest.mark.parametrize("name", MOE_MLA)
def test_moe_mla_cached_decode_on_card_tracks_cpu(cuda_device, name):
    """A 12-token prefill into the contiguous cache and 6 decode steps fed
    the CPU's greedy tokens (deepseek: the absorbed MLA path over both
    stacks' latents): logits within 1e-3 * max|logit| (the caches hold
    bfloat16)."""
    cfg, cpu, cparams, card, params = _reduced_pair(name, cuda_device)
    feed = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    ccache, gcache = cpu.init_cache(2, 24), card.init_cache(2, 24)
    for _ in range(7):
        want, ccache = cpu.forward(cparams, {"tokens": feed}, ccache)
        got, gcache = card.forward(params, {"tokens": feed.to(cuda_device)}, gcache)
        np.testing.assert_allclose(got[:, -1].cpu().numpy(), want[:, -1].numpy(), rtol=0,
                                   atol=1e-3 * float(want[:, -1].abs().max()))
        feed = torch.argmax(want[:, -1], dim=-1)[:, None].to(torch.int32)
    assert int(gcache["pos"]) == int(ccache["pos"]) == 18


@pytest.mark.parametrize("name", MOE_MLA)
def test_apply_moe_on_card_is_deterministic(cuda_device, name):
    """The bfloat16 MoE block twice on the same input on the card: bit for
    bit (stable top-k, a combine in a fixed order, no atomics in the
    sums); at float32 within rtol 1e-4 of the CPU's, with routing and
    capacity drops (capacity_factor 0.5) the CPU's."""
    from repro_torch.models import blocks
    from repro_torch.models import nn as mnn

    cfg, _, cparams, _, params = _reduced_pair(name, cuda_device, moe=dict(capacity_factor=0.5))
    x = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    p_card, p_cpu = mnn.layer(params["blocks"], 0)["mlp"], mnn.layer(cparams["blocks"], 0)["mlp"]
    xb = torch.from_numpy(x).to(cuda_device).to(torch.bfloat16)
    bf = cfg.scaled(dtype="bfloat16")
    assert torch.equal(blocks.apply_moe(p_card, xb, bf), blocks.apply_moe(p_card, xb, bf))
    got = blocks.apply_moe(p_card, torch.from_numpy(x).to(cuda_device), cfg)
    want = blocks.apply_moe(p_cpu, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


def test_moe_dense_layers_evict_on_card_invisibly(cuda_device):
    """The reduced llama4-scout with a leading dense layer in the paged
    batcher on the card, under page pressure at `Policy.raw()`: both
    stacks' arenas evict and restore, and every token stream equals the
    pressure-free run's."""
    from repro_torch.runtime.batcher import ContinuousBatcher, Request

    cfg, _, _, model, params = _reduced_pair("llama4-scout-17b-a16e", cuda_device,
                                             moe=dict(n_dense_layers=1), n_layers=3)
    prompts = _serving_prompts(cfg, 6, 4, 12)

    def run(arena_pages):
        b = ContinuousBatcher(model, params, slots=2, max_len=32, eos_id=-1, page_tokens=8,
                              arena_pages=arena_pages, policies=Policy.raw())
        reqs = [Request(rid=i, prompt=p, max_new=20) for i, p in enumerate(prompts)]
        b.run(reqs)
        return reqs, b

    calm_reqs, calm = run(None)
    tight_reqs, tight = run(5)
    assert "dense_blocks" in tight.cache and tight.cache["dense_blocks"]["k"].device.type == "cuda"
    assert calm.stats["evictions"] == 0
    assert tight.stats["evictions"] > 0 and tight.stats["restores"] > 0
    assert [r.out for r in calm_reqs] == [r.out for r in tight_reqs]


# -- the recurrent families on the card -------------------------------------

RECURRENT = ["zamba2-1.2b", "xlstm-1.3b"]


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_logits_on_card_equal_cpu(cuda_device, name):
    """float32 logits and loss of the reduced hybrid (SSD chunks, the shared
    attention) and xLSTM (chunked mLSTM, sLSTM loop) without a cache on
    the card against the CPU, TF32 off: rtol 1e-4, atol 1e-5 * max|logit|;
    loss to rtol 1e-5."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, cparams, card, params = _reduced_pair(name, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    want, _ = cpu.forward(cparams, batch)
    got, _ = card.forward(params, {k: v.to(cuda_device) for k, v in batch.items()})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    loss = card.loss(params, {k: v.to(cuda_device) for k, v in batch.items()})[0]
    np.testing.assert_allclose(float(loss), float(cpu.loss(cparams, batch)[0]), rtol=1e-5)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_greedy_decode_on_card_tracks_cpu(cuda_device, name):
    """A 12-token prefill into the contiguous cache and 8 greedy decode
    steps on the card and on the CPU, each fed its own greedy tokens: equal
    token streams, logits within 1e-3 * max|logit| (the hybrid's K/V and
    xLSTM's conv state are bfloat16 in the cache)."""
    cfg, cpu, cparams, card, params = _reduced_pair(name, cuda_device)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    ccache, gcache = cpu.init_cache(2, 24), card.init_cache(2, 24)
    cfeed, gfeed = prompt, prompt.to(cuda_device)
    ctoks, gtoks = [], []
    for _ in range(9):
        want, ccache = cpu.forward(cparams, {"tokens": cfeed}, ccache)
        got, gcache = card.forward(params, {"tokens": gfeed}, gcache)
        np.testing.assert_allclose(got[:, -1].cpu().numpy(), want[:, -1].numpy(), rtol=0,
                                   atol=1e-3 * float(want[:, -1].abs().max()))
        cfeed = torch.argmax(want[:, -1], dim=-1)[:, None].to(torch.int32)
        gfeed = torch.argmax(got[:, -1], dim=-1)[:, None].to(torch.int32)
        ctoks.append(cfeed)
        gtoks.append(gfeed.cpu())
    assert torch.equal(torch.cat(gtoks, 1), torch.cat(ctoks, 1))
    assert int(gcache["pos"]) == int(ccache["pos"]) == 20


# -- the encoder-decoder, and the train step of every family on the card ----


def test_encdec_cached_decode_on_card_tracks_cpu(cuda_device):
    """The reduced seamless-m4t-large-v2 at float32: 8 tokens one at a time
    through the cache, frames with the first (the encoder runs once, its
    memory is written into the cache and read back by the later steps), on
    the card and on the CPU: logits within 1e-3 * max|logit| (the K/V are
    bfloat16 in the cache), and the whole within 5e-2 * max|logit| of the
    card's parallel forward (tests/test_arch_smoke.py's bound)."""
    cfg, cpu, cparams, card, params = _reduced_pair("seamless-m4t-large-v2", cuda_device)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.frontend_len, cfg.d_model))
                              .astype(np.float32))
    full, _ = card.forward(params, {"tokens": toks.to(cuda_device),
                                    "frames": frames.to(cuda_device)})
    ccache, gcache = cpu.init_cache(2, 16), card.init_cache(2, 16)
    outs = []
    for t in range(8):
        cb = {"tokens": toks[:, t:t + 1]}
        if t == 0:
            cb["frames"] = frames
        want, ccache = cpu.forward(cparams, cb, ccache)
        got, gcache = card.forward(params, {k: v.to(cuda_device) for k, v in cb.items()}, gcache)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-3 * float(want.abs().max()))
        outs.append(got)
    assert int(gcache["pos"]) == 8 and gcache["memory"].device.type == "cuda"
    dec = torch.cat(outs, dim=1)
    scale = float(full.abs().max())
    assert float((dec - full).abs().max()) / scale < 5e-2


ZOO = ["llama4-scout-17b-a16e", "deepseek-v2-236b", "zamba2-1.2b", "xlstm-1.3b",
       "seamless-m4t-large-v2"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_train_step_on_card_tracks_cpu(cuda_device, name):
    """One `make_train_step` with gradient compression of each reduced
    family at float32 from the same weights on the card and on the CPU
    (the encoder-decoder's batch carries frames): losses within rtol 1e-5,
    grad norms within rtol 1e-4, params within 1e-5 * max|p| plus
    2 * lr, the most a flipped gradient code can move one Adam step
    (tests/test_torch_train.py)."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime.steps import init_opt_state, make_train_step

    cfg, cpu, cparams, card, params = _reduced_pair(name, cuda_device)
    batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4), 0)
    if cfg.encdec:
        batch["frames"] = np.random.default_rng(5).standard_normal(
            (4, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    gc = GradCompressConfig(eb_rel=1e-3)
    opt = AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5)
    out = {}
    for dev, model, p in (("cpu", cpu, cparams), (cuda_device, card, params)):
        step = make_train_step(model, opt, gc)
        p, _, m = step(p, init_opt_state(p, gc), {k: torch.from_numpy(v).to(dev)
                                                  for k, v in batch.items()})
        assert all(v.device.type == torch.device(dev).type for v in m.values())
        out[str(dev)] = (p, {k: float(v) for k, v in m.items()})
    (wp, wm), (gp, gm) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(gm["loss"], wm["loss"], rtol=1e-5)
    np.testing.assert_allclose(gm["grad_norm"], wm["grad_norm"], rtol=1e-4)
    for a, b in zip(_tree_leaves(gp), _tree_leaves(wp), strict=True):
        assert a.device.type == "cuda"
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-5 * float(b.abs().max()) + 2 * wm["lr"], err


def test_sharded_two_ranks_on_card(cuda_device, tmp_path):
    """Two ranks share the card over gloo (`launch/mhrun.py`): shard-local
    decisions equal the unsharded `select_many` on the card (samples
    exactly, stats to the golden tolerances), each rank's SZ segments run
    K1 (2-D) and K2 (3-D) on the card, and every segment decodes within eb.
    A gather-path field under `compress_pytree(sharded=True,
    device_encode=True)` with no device given is encoded by K1 on every
    rank: its host copy goes to the card, not to the CPU coder."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import torch_shard_worker as W

    _build.build()
    payloads = W.run_job("card", 2, tmp_path, timeout_s=300.0)
    launched = {"lorenzo2d_encode": 0, "lorenzo3d_encode": 0}
    for p in payloads:
        assert p["backend"] == "gloo" and all(d.startswith("cuda") for d in p["device"])
        for name, rec in p["samples"].items():
            assert rec["equal"] and rec["path"] == "shard-local", (name, rec)
            st = p["stats"][name]
            assert st["codec"] == rec["codec"], name
            assert abs(st["eb_sz"] - rec["eb_sz"]) <= 1e-5 * rec["eb_sz"], name
            assert abs(st["br_sz"] - rec["br_sz"]) <= 5e-3, name
        for seg, (codec, err, eb) in p["segments"].items():
            assert codec in ("sz", "zfp") and err <= eb, (seg, codec, err, eb)
        for name in launched:
            launched[name] += p["launches"][name]
    assert payloads[0]["samples"] == payloads[1]["samples"]
    assert all(n >= 1 for n in launched.values()), launched
    # every rank encodes the gathered field (each holds the whole tree)
    g0, g1 = payloads[0]["gather"], payloads[1]["gather"]
    for g in (g0, g1):
        assert g["path"] == "gather" and g["codec"] == "sz", g
        assert g["launches"]["lorenzo2d_encode"] >= 1, g
    assert g0["err"] <= g0["eb"] and g1["err"] == g0["err"], (g0, g1)

