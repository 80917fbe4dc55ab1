"""The port's BOT kernels (K5 2-D, K6 3-D) and Lorenzo dequantize kernels
(K3 2-D, K4 3-D) against the reference, on the CPU.

On the CPU the wrappers run their plain torch versions; they are held
against the reference's Pallas kernels in interpret mode, through
`repro.kernels.ops.bot_fused` and `lorenzo_decode`, on numpy-seeded fields.
Tolerances:

* BOT bits per block: equal.
* BOT recon: within 1e-5 * max|x| of the reference (tests/test_kernels.py's
  own tolerance) on every block whose float32 powers of two the reference
  computes exactly. The reference's compiled `exp2` on the CPU is exact
  only for integer arguments in [-12, 12] (and its `log2` not at every
  power of two), so where a block's plane step 2^p lies outside that range
  the reference's step is off by up to ~1e-6 relative, which can move a
  coefficient's truncation across an integer and the reconstruction by a
  fraction of eb; there the port is held to the contract |recon - x| <= eb,
  which it meets everywhere. The port computes every power of two exactly.
* Lorenzo decode (K3/K4): exact.
* Other ranks (`zfp_stats`): equal bit totals, recon within 1e-5 * max|x|,
  PSNR, MSE and mean n_sb to a relative 1e-5.

The CUDA kernels are held against these plain versions on the card by
`test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import zfp as r_zfp
from repro.core.transforms import bot_linf_gain as r_bot_linf_gain
from repro.core.transforms import bot_matrix as r_bot_matrix
from repro.kernels import lorenzo as r_lorenzo
from repro.kernels import ops as r_ops
from repro_torch.core import zfp as p_zfp
from repro_torch.core.transforms import bot_linf_gain
from repro_torch.kernels import bot4, lorenzo, ops, ref

SHAPES = [(300, 517), (8, 128), (4, 40), (7, 64, 64), (16, 96, 128), (4, 4, 129)]
TRANSFORMS = ["zfp", "hwt", "dct2"]


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _pow2_max_field(shape, seed):
    """Every 4-block's largest magnitude an exact power of two, the knife
    edge of e = ceil(log2 max|b|); signs mixed, ragged edges included."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, shape)
    k = rng.integers(-6, 7, size=tuple(-(-s // 4) for s in shape))
    scale = np.ldexp(1.0, k)
    for axis in range(len(shape)):
        scale = np.repeat(scale, 4, axis=axis)
    scale = scale[tuple(slice(0, s) for s in shape)]
    x = x * scale
    corner = tuple(slice(0, None, 4) for _ in shape)
    x[corner] = np.where(x[corner] < 0, -1.0, 1.0) * scale[corner]
    return x.astype(np.float32)


def _block_view(a, shape):
    """(d1,..,dn) float array -> (grid..., 4^n) with zero padding."""
    nd = len(shape)
    padded = np.pad(a, [(0, (-s) % 4) for s in shape])
    split = []
    for s in padded.shape:
        split += [s // 4, 4]
    perm = [2 * i for i in range(nd)] + [2 * i + 1 for i in range(nd)]
    return padded.reshape(split).transpose(perm).reshape(padded.shape[:0] + tuple(
        s // 4 for s in padded.shape) + (-1,))


def _ref_exact_blocks(x, eb, transform):
    """Per block: True where the reference's float32 exp2/log2 are exact at
    the block's exponent e and plane exponent p, so its arithmetic is the
    exact arithmetic the port does."""
    nd = x.ndim
    blocks = _block_view(x.astype(np.float64), x.shape)
    mx = np.maximum(np.abs(blocks).max(axis=-1), np.float32(1e-30))
    mant, ex = np.frexp(mx.astype(np.float32))
    e = np.where(mant == 0.5, ex - 1, ex)
    gain = np.float32(bot_linf_gain(transform) ** nd)
    raw = np.maximum(np.float32(eb) / (np.ldexp(np.float32(1), e).astype(np.float32) * gain),
                     np.float32(2.0**-60)).astype(np.float32)
    p = np.frexp(raw)[1] - 1
    ok = np.ones(e.shape, dtype=bool)
    for k in (e, -e, p):
        kf = jnp.asarray(k.astype(np.float32))
        exact = np.ldexp(np.float32(1), k).astype(np.float32)
        ok &= np.asarray(jnp.exp2(kf)) == exact
        ok &= np.asarray(jnp.log2(jnp.asarray(exact))) == k
    return ok


def _check_bot(x, eb, transform):
    r_recon, r_bits = r_ops.bot_fused(jnp.asarray(x), eb, transform=transform)
    recon, bits = ops.bot_fused(torch.from_numpy(x), eb, transform)
    r_recon, r_bits = np.asarray(r_recon), np.asarray(r_bits)
    recon, bits = recon.numpy(), bits.numpy()
    assert bits.shape == r_bits.shape == tuple(-(-s // 4) for s in x.shape)
    np.testing.assert_array_equal(bits, r_bits)
    assert recon.shape == x.shape and recon.dtype == np.float32
    exact = _ref_exact_blocks(x, eb, transform)
    diff = _block_view(np.abs(recon.astype(np.float64) - r_recon), x.shape)
    tol = 1e-5 * float(np.abs(x).max())
    assert float(diff[exact].max(initial=0.0)) <= tol
    assert float(np.abs(recon.astype(np.float64) - x).max()) <= eb
    return exact


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_bot_fused_matches_reference(shape, transform):
    x = _field(shape, 3)
    exact = _check_bot(x, 1e-3 * float(x.max() - x.min()), transform)
    assert exact.mean() > 0.5  # the comparison is not vacuous


@pytest.mark.parametrize("shape", [(300, 517), (4, 40), (7, 64, 64), (4, 4, 129)])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_bot_fused_power_of_two_max_blocks(shape, transform):
    x = _pow2_max_field(shape, 4)
    blocks = _block_view(np.abs(x), shape).max(axis=-1)
    assert np.all(np.frexp(blocks)[0] == 0.5)  # every block max is 2^k
    exact = _check_bot(x, 1e-3 * float(x.max() - x.min()), transform)
    assert exact.all()


@pytest.mark.parametrize("shape", [(4096,), (2, 3, 8, 32)])
def test_bot_fused_other_ranks_take_zfp_stats(shape):
    """Ranks other than 2 and 3 return (zfp_stats recon, None); the port's
    zfp_stats is held against the reference's on the same field."""
    x = _field(shape, 5)
    eb = 1e-2 * float(x.max() - x.min())
    r = r_zfp.zfp_stats(jnp.asarray(x), eb)
    p = p_zfp.zfp_stats(torch.from_numpy(x), eb)
    assert float(p.bitrate) == float(r.bitrate)  # integer bit totals
    tol = 1e-5 * float(np.abs(x).max())
    np.testing.assert_allclose(p.recon.numpy(), np.asarray(r.recon), rtol=0, atol=tol)
    for k in ("psnr", "mse", "mean_nsb"):
        np.testing.assert_allclose(float(getattr(p, k)), float(getattr(r, k)), rtol=1e-5)
    r_recon, r_bits = r_ops.bot_fused(jnp.asarray(x), eb)
    recon, bits = ops.bot_fused(torch.from_numpy(x), eb)
    assert bits is None and r_bits is None
    np.testing.assert_allclose(recon.numpy(), np.asarray(r_recon), rtol=0, atol=tol)
    np.testing.assert_array_equal(recon.numpy(), p.recon.numpy())


@pytest.mark.parametrize("shape", SHAPES + [(4096,), (2, 3, 8, 32)])
def test_lorenzo_decode_exact(shape):
    x = _field(shape, 7)
    eb = 1e-3 * float(x.max() - x.min())
    # the port's codes equal the reference's (test_torch_kernels.py)
    d = ops.lorenzo_encode(torch.from_numpy(x), eb).numpy()
    want = np.asarray(r_ops.lorenzo_decode(jnp.asarray(d), eb))
    got = ops.lorenzo_decode(torch.from_numpy(d), eb).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    tol = eb + 4 * float(np.spacing(np.float32(np.abs(x).max())))
    assert float(np.abs(got - x).max()) <= tol


@pytest.mark.parametrize("shape", [(256, 256), (8, 64, 256)])
def test_dequantize_wrappers_match_pallas(shape):
    """K3/K4 called directly, against the reference kernels (exact)."""
    rng = np.random.default_rng(8)
    k = rng.integers(-(2**30), 2**30, size=shape, dtype=np.int32)
    eb = 0.0123
    r_fn = r_lorenzo.dequantize2d if len(shape) == 2 else r_lorenzo.dequantize3d
    p_fn = lorenzo.dequantize2d if len(shape) == 2 else lorenzo.dequantize3d
    want = np.asarray(r_fn(jnp.asarray(k), eb, block=shape))
    np.testing.assert_array_equal(p_fn(torch.from_numpy(k), eb).numpy(), want)


def test_pow2_is_exact_everywhere():
    k = np.arange(-160, 140)
    got = ref.pow2(torch.from_numpy(k.astype(np.int32))).numpy()
    with np.errstate(over="ignore"):
        want = np.ldexp(np.float32(1), k).astype(np.float32)  # 0 / inf at the ends
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("nd", [2, 3])
def test_kernel_constants_are_cached_per_transform_and_rank(transform, nd):
    """The BOT wrappers' constant kernel arguments, built once per
    (transform, rank): T(t) and gain^nd rounded to float32 as the
    reference rounds them."""
    T, gain = bot4._constants(transform, nd)
    assert bot4._constants(transform, nd)[0] is T
    np.testing.assert_array_equal(np.ctypeslib.as_array(T),
                                  np.float32(r_bot_matrix(transform)).reshape(-1))
    assert gain.value == np.float32(r_bot_linf_gain(transform) ** nd)


@pytest.mark.parametrize("name,ndim,dtype", [
    ("bot2d_fused", 2, torch.float32), ("bot3d_fused", 3, torch.float32),
    ("dequantize2d", 2, torch.int32), ("dequantize3d", 3, torch.int32),
])
def test_new_wrappers_reject_bad_inputs(name, ndim, dtype):
    kernel = getattr(bot4, name, None) or getattr(lorenzo, name)
    good = torch.zeros((8,) * ndim, dtype=dtype)
    with pytest.raises(ValueError):
        kernel(torch.zeros((8,) * (ndim + 1), dtype=dtype), 0.1)  # wrong rank
    with pytest.raises(TypeError):
        kernel(good.double(), 0.1)  # wrong dtype
    with pytest.raises(ValueError):
        kernel(good.transpose(0, 1), 0.1)  # not contiguous
    with pytest.raises(TypeError):
        kernel(good.numpy(), 0.1)  # not a tensor
    if name.startswith("bot"):
        with pytest.raises(ValueError):
            kernel(good, 0.1, "nope")  # unknown transform
        with pytest.raises(ValueError):
            kernel(good, torch.ones(2))  # eb is one value


def test_cpu_calls_do_not_count_as_launches():
    before = dict(bot4.LAUNCHES), dict(lorenzo.LAUNCHES)
    bot4.bot2d_fused(torch.ones(8, 8), 0.1)
    bot4.bot3d_fused(torch.ones(4, 8, 8), 0.1)
    lorenzo.dequantize2d(torch.ones(8, 8, dtype=torch.int32), 0.1)
    lorenzo.dequantize3d(torch.ones(4, 8, 8, dtype=torch.int32), 0.1)
    assert (dict(bot4.LAUNCHES), dict(lorenzo.LAUNCHES)) == before
