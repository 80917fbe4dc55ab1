"""The port's Lorenzo encode kernels (K1 2-D, K2 3-D) against the reference.

On the CPU the wrappers run their plain torch versions; every code is held
three ways, exactly: the port, the reference's Pallas kernels (interpret
mode on the CPU, through `repro.kernels.ops.lorenzo_encode`) and the
reference's plain jnp oracle (`repro.kernels.ref`). The CUDA kernels
themselves are held against the plain versions on the card by the
`cuda`-marked tests of `test_torch_cuda.py` and by `chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import lorenzo, ops, ref

SHAPES = [(300, 517), (8, 128), (4, 40), (7, 64, 64), (4, 4, 129)]


def _field(shape, seed, kind="walk"):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _three_way(x, eb):
    """(port, reference Pallas kernel, reference jnp oracle) codes."""
    port = ops.lorenzo_encode(torch.from_numpy(x), eb).numpy()
    pallas = np.asarray(r_ops.lorenzo_encode(jnp.asarray(x), jnp.float32(eb)))
    oracle = np.asarray(r_ref.lorenzo_encode_ref(jnp.asarray(x), eb))
    return port, pallas, oracle


def _kernel_for(ndim):
    return lorenzo.lorenzo2d_encode if ndim == 2 else lorenzo.lorenzo3d_encode


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["walk", "noise"])
def test_lorenzo_encode_matches_reference(shape, kind):
    x = _field(shape, 0, kind)
    eb = 1e-3 * float(x.max() - x.min())
    port, pallas, oracle = _three_way(x, eb)
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, oracle)
    # the wrapper of the rank's kernel, called directly
    direct = _kernel_for(len(shape))(torch.from_numpy(x), eb).numpy()
    np.testing.assert_array_equal(direct, pallas)


@pytest.mark.parametrize("shape", SHAPES)
def test_lorenzo_encode_half_bin_ties(shape):
    """Values exactly at (k + 0.5) * delta round half to even, as jnp.round."""
    rng = np.random.default_rng(1)
    eb = 2.0**-7
    delta = 2 * eb
    k = rng.integers(-1000, 1000, size=shape)
    x = ((k + 0.5) * delta).astype(np.float32)
    port, pallas, oracle = _three_way(x, eb)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, oracle)
    codes = torch.round(torch.from_numpy(x) / delta)
    assert bool(((codes % 2) == 0).all())  # every tie went to the even code


@pytest.mark.parametrize("shape", SHAPES)
def test_lorenzo_encode_codes_near_2p22(shape):
    """Codes near +-2^22 with neighbours of both signs: every float32
    intermediate of the Lorenzo sum stays an exact integer."""
    rng = np.random.default_rng(2)
    eb = 0.5
    k = (2**22 - rng.integers(0, 64, size=shape)) * rng.choice([-1, 1], size=shape)
    x = k.astype(np.float32) * np.float32(2 * eb)
    port, pallas, oracle = _three_way(x, eb)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, oracle)
    assert int(np.abs(port).max()) > 2**22


@pytest.mark.parametrize(
    "shape", [(4, 40), (8, 40), (7, 64, 64), (4096,), (2, 3, 8, 32, 32)]
)
def test_dispatch_predicate_matches_reference(shape):
    assert ops.pallas_rank(shape) == r_ops.pallas_rank(shape)
    x = _field(shape, 6)
    eb = 1e-3 * float(x.max() - x.min())
    np.testing.assert_array_equal(
        ops.lorenzo_encode(torch.from_numpy(x), eb).numpy(),
        np.asarray(r_ref.lorenzo_encode_ref(jnp.asarray(x), eb)),
    )


def test_dispatch_predicate_edges():
    assert ops.pallas_rank((0, 40)) is None
    assert ops.pallas_rank((1, 5)) == 2
    assert ops.pallas_rank((96, 256, 256)) == 3


@pytest.mark.parametrize("shape", [(40, 33), (6, 20, 9)])
def test_lorenzo_decode_ref_matches_reference(shape):
    x = _field(shape, 3)
    eb = 1e-3 * float(x.max() - x.min())
    d = r_ref.lorenzo_encode_ref(jnp.asarray(x), eb)
    want = np.asarray(r_ref.lorenzo_decode_ref(d, eb))
    got = ref.lorenzo_decode_ref(torch.from_numpy(np.array(d)), eb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.max(np.abs(got - x)) <= eb * (1 + 1e-5)


@pytest.mark.parametrize("name,ndim", [("lorenzo2d_encode", 2), ("lorenzo3d_encode", 3)])
def test_wrapper_rejects_bad_inputs(name, ndim):
    kernel = getattr(lorenzo, name)
    good = torch.zeros((8,) * ndim)
    with pytest.raises(ValueError):
        kernel(torch.zeros((8,) * (ndim + 1)), 0.1)  # wrong rank
    with pytest.raises(TypeError):
        kernel(good.double(), 0.1)  # wrong dtype
    with pytest.raises(ValueError):
        kernel(good.transpose(0, 1), 0.1)  # not contiguous
    with pytest.raises(TypeError):
        kernel(np.zeros((8,) * ndim, np.float32), 0.1)  # not a tensor


def test_cpu_calls_do_not_count_as_launches():
    before = dict(lorenzo.LAUNCHES)
    lorenzo.lorenzo2d_encode(torch.ones(8, 8), 0.1)
    lorenzo.lorenzo3d_encode(torch.ones(4, 8, 8), 0.1)
    assert lorenzo.LAUNCHES == before


#: ranks the kernels do not serve, which take the plain path
OTHER_RANKS = [(4096,), (2, 3, 8, 32)]


@pytest.mark.parametrize("shape", SHAPES + OTHER_RANKS)
@pytest.mark.parametrize("sigma", [3e7, 1e9])
def test_lorenzo_encode_beyond_2p24(shape, sigma):
    """Codes past 2^24 (where the float32 difference rounds, so its order
    matters) and past int32 (where the cast saturates), at eb 0.5: exact
    against the reference's kernel path."""
    x = np.random.default_rng(7).normal(0.0, sigma, shape).astype(np.float32)
    port = ops.lorenzo_encode(torch.from_numpy(x), 0.5).numpy()
    want = np.asarray(r_ops.lorenzo_encode(jnp.asarray(x), jnp.float32(0.5)))
    np.testing.assert_array_equal(port, want)
    assert int(np.abs(port.astype(np.int64)).max()) > 2**24
    if len(shape) in (2, 3):
        direct = _kernel_for(len(shape))(torch.from_numpy(x), 0.5).numpy()
        np.testing.assert_array_equal(direct, want)


def _non_finite_spots(shape):
    """Spots on the first row and column (in 3-D the first plane, row and
    column) and inside. None lies on a last row, column or plane: the
    reference's halo views wrap there (ROADMAP queue C)."""
    if len(shape) == 2:
        m, n = shape
        return [(0, 0), (0, n // 2), (m // 2, 0), (m // 2, n // 3)]
    z, m, n = shape
    return [(0, m // 2, n // 2), (z // 2, 0, n // 2), (z // 2, m // 2, 0),
            (z // 2, m // 2, n // 3)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("value", [np.inf, -np.inf, np.nan])
def test_lorenzo_encode_non_finite(shape, value):
    """+-inf and NaN on the domain's first row, first column and inside:
    the codes around them saturate or go to 0 as the reference's do."""
    x = _field(shape, 8)
    for spot in _non_finite_spots(shape):
        x[spot] = value
    port, pallas, _ = _three_way(x, 0.01)
    np.testing.assert_array_equal(port, pallas)
    direct = _kernel_for(len(shape))(torch.from_numpy(x), 0.01).numpy()
    np.testing.assert_array_equal(direct, pallas)


@pytest.mark.parametrize("shape", SHAPES)
def test_lorenzo_decode_prefix_beyond_int32(shape):
    """A prefix sum that leaves the int32 range saturates before the
    dequantize, as the reference's cast does. The codes are multiples of
    2^26, so every float32 partial sum is exact in any order."""
    rng = np.random.default_rng(9)
    d = rng.integers(-3, 4, size=shape) * (rng.random(shape) < 0.2) * 2**26
    d[(0,) * len(shape)] = d[(0,) * (len(shape) - 1) + (1,)] = 2**30  # the sum reaches 2^31
    d = d.astype(np.int32)
    got = ops.lorenzo_decode(torch.from_numpy(d), 0.5).numpy()
    want = np.asarray(r_ops.lorenzo_decode(jnp.asarray(d), jnp.float32(0.5)))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() == 2.0**31  # some prefix sums saturated
