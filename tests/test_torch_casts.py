"""Float-to-integer casts on +-inf and NaN: every site in the port casts as
XLA's convert does (NaN -> 0, +-inf and out-of-range values to the integer
type's limits), so each agrees with the same reference function on CPU
JAX. A bare torch `.to(int)` is undefined there and wraps on the host
(inf -> INT32_MIN).

The sites: `device.to_int_saturating` itself (int8 and int32),
`embedded.block_exponent`, the block exponents of `estimator.estimate_zfp`
and `estimate_zfp_many`, the int8 KV codes of `kvcomp.quantize_kv`, the
plane magnitudes of the ZFP device encoder, and the (field, bin) sort key
of `estimator.estimate_sz_many`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_encode as r_de
from repro.core import embedded as r_emb
from repro.core import estimator as r_est
from repro.runtime import kvcomp as r_kv
from repro_torch import device as p_device
from repro_torch.core import device_encode as p_de
from repro_torch.core import embedded as p_emb
from repro_torch.core import estimator as p_est
from repro_torch.runtime import kvcomp as p_kv

KINDS = ["inf", "-inf", "nan", "all"]


def _poisoned(shape, kind, seed=0):
    """A random walk with +inf, -inf or NaN (or all three) planted inside
    and on the first row."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.standard_normal(shape), -1).astype(np.float32)
    vals = {"inf": [np.inf], "-inf": [-np.inf], "nan": [np.nan],
            "all": [np.inf, -np.inf, np.nan]}[kind]
    flat = x.reshape(-1)
    spots = [0, 5] + list(rng.integers(0, flat.size, size=4))
    for i, s in enumerate(spots):
        flat[s] = vals[i % len(vals)]
    return x


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_saturating_cast_matches_xla_convert(dtype):
    v = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 0.7, -0.7, 126.9, 127.5, 128.0,
                  -128.0, -128.5, -129.0, 300.0, -300.0, 2.0**31, -(2.0**31), 2.0**31 - 128,
                  3e9, -3e9, 1e38, -1e38], np.float32)
    want = jax.jit(lambda a: a.astype(dtype))(jnp.asarray(v))
    got = p_device.to_int_saturating(torch.from_numpy(v), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _same(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_block_exponent_non_finite(kind):
    blocks = _poisoned((24, 4, 4), kind).reshape(24, 4, 4)
    want = jax.jit(r_emb.block_exponent)(jnp.asarray(blocks))
    _same(p_emb.block_exponent(torch.from_numpy(blocks)), want)


def _estimate(e):
    return e.bitrate, e.psnr


@functools.cache
def _ref_estimate_zfp(shape):
    """The reference's `estimate_zfp`, jitted once per shape (as its
    selector runs it)."""
    starts = r_est.block_starts(shape, 0.25)
    return starts, jax.jit(lambda v, eb, vr: _estimate(r_est.estimate_zfp(v, eb, starts, vr)))


@functools.cache
def _ref_many(name):
    return jax.jit(lambda *a: _estimate(getattr(r_est, name)(*a)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(32, 40), (8, 16, 20)])
def test_estimate_zfp_non_finite(kind, shape):
    x = _poisoned(shape, kind, 1)
    starts, ref = _ref_estimate_zfp(shape)
    eb, vr = 0.01, 30.0
    want = ref(jnp.asarray(x), eb, vr)
    got = _estimate(p_est.estimate_zfp(torch.from_numpy(x), eb, starts, vr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, equal_nan=True)


def _batch(shape, kind, halo):
    x = _poisoned(shape, kind, 2)
    starts = r_est.block_starts(shape, 0.25)
    blocks = r_est.gather_blocks_np(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0), starts,
                                    halo=halo)
    raw = r_est.gather_blocks_np(x, starts, halo=False)
    if halo:  # the poisoned values inside the blocks, zero halo rows kept
        blocks[(slice(None),) + (slice(1, None),) * len(shape)] = raw
    else:
        blocks = raw
    n = len(blocks)
    seg = np.zeros(n, np.int32)
    seg[n // 2:] = 1
    bounds = np.array([0, n // 2, n], np.int32)
    return blocks, seg, bounds


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(32, 40), (8, 16, 20)])
def test_estimate_zfp_many_non_finite(kind, shape):
    blocks, seg, bounds = _batch(shape, kind, halo=False)
    eb = np.array([0.01, 0.02], np.float32)
    vr = np.array([30.0, 30.0], np.float32)
    args = (blocks, seg, bounds, eb, vr)
    want = _ref_many("estimate_zfp_many")(*map(jnp.asarray, args))
    got = _estimate(p_est.estimate_zfp_many(*map(torch.from_numpy, args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(32, 40), (8, 16, 20)])
def test_estimate_sz_many_sort_key_non_finite(kind, shape):
    """NaN and +-inf residuals: the bin's cast saturates (NaN -> bin 0 of its
    field), so the runs, counts and rates follow the reference's."""
    blocks, seg, bounds = _batch(shape, kind, halo=True)
    delta = np.array([0.02, 0.04], np.float32)
    vr = np.array([30.0, 30.0], np.float32)
    size = np.array([1e4, 1e4], np.float32)
    args = (blocks, seg, bounds, delta, vr, size)
    want = _ref_many("estimate_sz_many")(*map(jnp.asarray, args))
    got = _estimate(p_est.estimate_sz_many(*map(torch.from_numpy, args)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-3, equal_nan=True)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_non_finite(kind):
    x = _poisoned((6, 32), kind, 3)
    x[-1] = np.linspace(-2, 2, 32)  # one finite row
    qr, sr = jax.jit(r_kv.quantize_kv)(jnp.asarray(x))
    qp, sp = p_kv.quantize_kv(torch.from_numpy(x))
    assert qp.dtype == torch.int8
    _same(qp.numpy(), qr)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sr))


@pytest.mark.parametrize("kind", KINDS)
def test_zfp_plane_magnitudes_non_finite(kind):
    """The plane magnitudes of non-finite coefficients: NaN -> 0 as in the
    reference, +-inf at the 2^24 guard (the reference's limit is 2^31 - 1;
    both decline the field on the non-finite maximum)."""
    rng = np.random.default_rng(4)
    coeffs = rng.uniform(-1, 1, (12, 4, 4)).astype(np.float32)
    flat = coeffs.reshape(-1)
    vals = {"inf": [np.inf], "-inf": [-np.inf], "nan": [np.nan],
            "all": [np.inf, -np.inf, np.nan]}[kind]
    for i, s in enumerate((0, 17, 100, 150)):
        flat[s] = vals[i % len(vals)]
    step = np.full(12, 2.0**-10, np.float32)
    m_r, _, _, _, _, mmax_r = r_de._zfp_pass2a(jnp.asarray(coeffs), jnp.asarray(step), nd=2)
    m_p, _, _, _, _, mmax_p = p_de._zfp_pass2a(torch.from_numpy(coeffs), torch.from_numpy(step), 2)
    m_r = np.asarray(m_r)
    assert m_p.dtype == torch.int32
    _same(m_p.numpy(), np.minimum(m_r, 2**24))
    assert not np.isfinite(float(mmax_p)) and not np.isfinite(float(mmax_r))
    if kind == "nan":
        assert float(m_p.max()) < 2**24
    x = _poisoned((16, 16), kind, 5)
    assert r_de.zfp_encode_device(x, 0.01) is None
    before = p_de.DECLINES["zfp/code_range"]
    assert p_de.zfp_encode_device(torch.from_numpy(x), 0.01) is None
    assert p_de.DECLINES["zfp/code_range"] == before + 1
