"""The port's Stage II quantizers (`repro_torch.core.quantize`), Lorenzo
prediction (`core.transforms.lorenzo_predict`) and SZ statistics
(`core.sz.sz_stats`, `sz_compressed_bits`) against the same functions of
`repro.core` on seeded numpy inputs, and the contracts of
`tests/test_quantizers.py`.

Codes, edges, reconstructions and outlier fractions are equal; the
float32 reductions (the entropy over 65,535 bins, the MSE) add in another
order than XLA's, and the log dequantizer's power is not XLA's, so those
are held to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as rq
from repro.core import sz as rsz
from repro.core import transforms as rtr
from repro_torch.core import quantize as q
from repro_torch.core import sz, transforms

RTOL = 1e-5


def _walk(shape, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("eb", [1e-3, 0.05, 0.5])
def test_linear_matches_reference(eb):
    x = _walk((64, 96), 0)
    codes = q.linear_quantize(_t(x), eb)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rq.linear_quantize(jnp.asarray(x), eb)))
    back = q.linear_dequantize(codes, eb)
    np.testing.assert_array_equal(back.numpy(), np.asarray(rq.linear_dequantize(jnp.asarray(codes.numpy()), eb)))
    assert back.dtype == torch.float32


def test_linear_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    eb = 1e-3
    back = q.linear_dequantize(q.linear_quantize(x, eb), eb)
    assert float(torch.max(torch.abs(back - x))) <= eb * 1.001


def _log_input(seed, n=4096):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10 ** rng.uniform(-3, 1, n)).astype(np.float32)


@pytest.mark.parametrize("n", [16, 512])
def test_log_matches_reference(n):
    x = _log_input(1)
    mx = float(np.abs(x).max())
    codes, bmx = q.log_quantize(_t(x), n, mx)
    rcodes, rbmx = rq.log_quantize(jnp.asarray(x), n, mx)
    np.testing.assert_array_equal(bmx.numpy(), np.asarray(rbmx))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    for nb in (n, None):
        back = q.log_dequantize(codes, bmx, n_bins_half=nb)
        want = rq.log_dequantize(rcodes, rbmx, n_bins_half=nb)
        np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def test_log_roundtrip_relative_error():
    x = torch.from_numpy(_log_input(1))
    n = 512
    codes, bmx = q.log_quantize(x, n, float(torch.max(torch.abs(x))))
    back = q.log_dequantize(codes, bmx, n_bins_half=n)
    mask = torch.abs(x) > float(bmx[1]) * 1e-6  # outside the dead zone
    rel = (torch.abs(back - x)[mask] / torch.abs(x)[mask]).numpy()
    b = float(bmx[0])
    assert rel.max() <= b - 1.0 + 1e-3, (rel.max(), b)


@pytest.mark.parametrize("size,bins", [(1 << 14, 64), (1000, 7)])
def test_equiprob_matches_reference(size, bins):
    x = np.random.default_rng(2).standard_normal(size).astype(np.float32)
    edges = q.equiprob_edges(_t(x), bins)
    redges = rq.equiprob_edges(jnp.asarray(x), bins)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(redges))
    codes = q.equiprob_quantize(_t(x), edges)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rq.equiprob_quantize(jnp.asarray(x), redges)))
    back = q.equiprob_dequantize(codes, edges)
    np.testing.assert_array_equal(back.numpy(), np.asarray(rq.equiprob_dequantize(
        jnp.asarray(codes.numpy()), redges)))


def test_equiprob_uniform_occupancy():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(1 << 14).astype(np.float32))
    edges = q.equiprob_edges(x, 64)
    codes = q.equiprob_quantize(x, edges)
    hist = np.bincount(codes.numpy().reshape(-1), minlength=64)
    assert hist.min() > 0.7 * x.numel() / 64 and hist.max() < 1.3 * x.numel() / 64
    assert torch.all(torch.isfinite(q.equiprob_dequantize(codes, edges)))


@pytest.mark.parametrize("shape", [(257,), (33, 40), (9, 10, 11)])
def test_lorenzo_predict_matches_reference(shape):
    x = _walk(shape, 3)
    got = transforms.lorenzo_predict(_t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rtr.lorenzo_predict(jnp.asarray(x))))


@pytest.mark.parametrize("shape,eb_rel,radius", [
    ((256, 256), 1e-3, sz.RESIDUAL_RADIUS),
    ((32, 48, 40), 1e-4, sz.RESIDUAL_RADIUS),
    ((128, 96), 1e-5, 4),  # most residuals beyond the bins: outliers
])
def test_sz_stats_matches_reference(shape, eb_rel, radius):
    x = _walk(shape, 5)
    eb = eb_rel * float(x.max() - x.min())
    got = sz.sz_stats(_t(x), eb, hist_radius=radius)
    want = rsz.sz_stats(jnp.asarray(x), eb, hist_radius=radius)
    np.testing.assert_array_equal(got.recon.numpy(), np.asarray(want.recon))
    assert float(got.outlier_frac) == float(want.outlier_frac)
    if radius == 4:
        assert float(got.outlier_frac) > 0.1
    for name in ("bitrate", "psnr", "mse"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=RTOL, err_msg=name)
    assert float(torch.max(torch.abs(got.recon - _t(x)))) <= eb * 1.001


def test_sz_stats_track_the_byte_codec():
    """The contract of tests/test_core_codecs.py: the in-graph rate is
    within 25% of the bytes `sz_compress` writes, and the reconstruction
    the byte codec's."""
    x = _walk((256, 256), 3)
    eb = 1e-3 * float(x.max() - x.min())
    st = sz.sz_stats(_t(x), eb)
    buf = sz.sz_compress(x, eb)
    actual = sz.sz_compressed_bits(buf) / x.size
    assert sz.sz_compressed_bits(buf) == rsz.sz_compressed_bits(buf) == 8 * len(buf)
    assert abs(float(st.bitrate) - actual) / actual < 0.25
    assert np.abs(st.recon.numpy() - sz.sz_decompress(buf)).max() < 2e-5 * np.abs(x).max()
