"""The ZFP estimates' `log2` at powers of two, against CPU JAX.

The reference's estimates run through XLA, whose float32 `log2` is one ulp
below the integer at 2^13, 2^15, 2^26, 2^27, ... and one above at the
negative powers. A block whose maximum is such a power gets another
exponent (a ceil), and a block whose largest truncated magnitude is 8192
or 32768 gets another plane count (a floor), so the port's estimates take
the same `log2` (`core/xla_f32.py`). The fields here are made of 4^nd
blocks, each constant at +-2^p (its maximum) or random below it, at a bound
that puts the constant blocks' DC coefficient at exactly 8192 or 32768
steps. The ZFP device encoder keeps the exact `log2` of the host coder, so
its block exponents still equal the host coder's on the same fields.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedded as r_emb
from repro.core import estimator as r_est
from repro.core import zfp as r_zfp
from repro_torch.core import device_encode as p_de
from repro_torch.core import embedded as p_emb
from repro_torch.core import estimator as p_est
from repro_torch.core import zfp as p_zfp
from repro_torch.core.transforms import bot_linf_gain

POWERS = [13, -13, 15, -15, 26, -26, 27, -27]
#: the largest truncated magnitude of the constant blocks: 2^13, 2^15
MAGNITUDES = [8192, 32768]
SHAPES = {1: (64,), 2: (16, 20), 3: (8, 8, 12)}


def _field(nd: int, p: int, seed: int) -> np.ndarray:
    """4^nd blocks: every other one constant at +-2^p, the rest random in
    (-2^p, 2^p) with one value at +2^p, so every block's maximum is 2^p."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[nd]
    top = np.float32(2.0**p)
    x = (rng.uniform(-1, 1, shape) * top * 0.75).astype(np.float32)
    grid = np.indices(tuple(s // 4 for s in shape)).reshape(nd, -1).T
    for i, b in enumerate(grid):
        sl = tuple(slice(4 * c, 4 * c + 4) for c in b)
        if i % 2 == 0:
            x[sl] = top * (1 if rng.random() < 0.5 else -1)
        else:
            x[sl].flat[int(rng.integers(4**nd))] = top
    return x


def _eb(nd: int, p: int, mag: int) -> float:
    """The bound whose plane step puts a constant block's DC coefficient
    (2^nd after normalization) at exactly `mag` steps."""
    return float(2.0**p * bot_linf_gain("zfp") ** nd * 2.0**nd / mag * 1.5)


@pytest.mark.parametrize("p", POWERS)
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_block_exponent_and_plane_step_equal_xla(nd, p):
    x = _field(nd, p, seed=nd * 100 + p)
    blocks = p_zfp.blockize(torch.from_numpy(x))[0]
    e_p = p_emb.block_exponent(blocks)
    e_r = np.asarray(r_emb.block_exponent(jnp.asarray(blocks.numpy())))
    assert np.array_equal(e_p.numpy(), e_r)
    gain = bot_linf_gain("zfp") ** nd
    for mag in MAGNITUDES:
        eb = _eb(nd, p, mag)
        got = p_emb.plane_step(torch.tensor(eb, dtype=torch.float32), e_p, gain)
        want = r_emb.plane_step(jnp.float32(eb), jnp.asarray(e_r), gain)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("p", POWERS)
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_zfp_estimates_equal_xla(nd, p, mag):
    """`zfp_stats`, the coder bit counts of the same coefficients
    (`exact_coder_bits_blocks`, `block_bits`) and `estimate_zfp(mode=
    'exact')` over every block equal the reference's bit for bit."""
    x = _field(nd, p, seed=nd * 100 + p)
    eb = _eb(nd, p, mag)
    a = r_zfp.zfp_stats(jnp.asarray(x), eb)
    b = p_zfp.zfp_stats(torch.from_numpy(x), eb)
    assert float(b.bitrate) == float(a.bitrate)
    # the mean's float32 sum order is torch's, not XLA's: the counts below
    # are compared exactly instead
    assert float(b.mean_nsb) == pytest.approx(float(a.mean_nsb), rel=1e-6)
    # the coefficients and step the reference takes, fed to both counters
    blocks = r_zfp.blockize(jnp.asarray(x))[0]
    norm, e = r_emb.align_blocks(blocks)
    coeffs = r_zfp.block_transform_nd(
        norm, jnp.asarray(r_zfp.bot_matrix("zfp"), jnp.float32), nd
    )
    step = r_emb.plane_step(jnp.float32(eb), e, bot_linf_gain("zfp") ** nd)
    c_t, s_t = torch.tensor(np.asarray(coeffs)), torch.tensor(np.asarray(step))
    assert np.array_equal(
        p_emb.significant_bits(c_t, s_t).numpy(),
        np.asarray(r_emb.significant_bits(coeffs, step)),
    )
    assert np.array_equal(
        p_emb.exact_coder_bits_blocks(c_t, s_t).numpy(),
        np.asarray(r_emb.exact_coder_bits_blocks(coeffs, step)),
    )
    assert np.array_equal(
        p_emb.block_bits(c_t, s_t).numpy(), np.asarray(r_emb.block_bits(coeffs, step))
    )
    starts = r_est.block_starts(x.shape, 1.0)
    vr = float(x.max() - x.min())
    want = r_est.estimate_zfp(jnp.asarray(x), eb, starts, vr, mode="exact")
    got = p_est.estimate_zfp(torch.from_numpy(x), eb, starts, vr, mode="exact")
    assert float(got.bitrate) == float(want.bitrate)


@pytest.mark.parametrize("mag", MAGNITUDES)
@pytest.mark.parametrize("p", POWERS)
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_zfp_device_codes_keep_the_host_coders_exponents(nd, p, mag):
    """The device encoder's block exponents stay the exact ones of the
    port's host coder (float64 numpy) on the same field, and its stream is
    the host coder's over the device's own codes. (Its float32 transform
    may put a magnitude one step from the host's float64 one, as in the
    reference; the exponents and the stream format may not differ.)"""
    x = _field(nd, p, seed=nd * 100 + p)
    eb = _eb(nd, p, mag)
    q, e = p_de.zfp_device_codes(torch.from_numpy(x), eb)
    _, e_host, *_ = p_zfp._prepare_blocks(x, eb, "zfp")
    assert np.array_equal(np.asarray(e).astype(np.int64), e_host.astype(np.int64))
    dev = p_de.zfp_encode_device(torch.from_numpy(x), eb)
    padded = tuple(s + (-s) % 4 for s in x.shape)
    assert dev is not None
    assert dev == p_zfp.zfp_encode_quantized(q, e, x.shape, padded, eb)
