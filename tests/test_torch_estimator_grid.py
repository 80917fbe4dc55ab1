"""`sz_delta_for_psnr` bit for bit against the reference on the CPU.

The SZ bin size comes from the PSNR snapped to a 0.05 dB grid, so every
point of that grid must give the reference's float32 delta exactly: a few
ulps move round(x / delta) at .5 ties. The reference evaluates the function
two ways. Inside `select` and `select_many` it is compiled, and XLA turns
its divisions by constants into multiplications; the controller's seed
calls it eagerly, op by op. Both forms end in the float32 `10.0 ** y`,
which is glibc's `powf` and is one ulp off the nearest float at some grid
points (81.40, 99.75 and 131.10 dB among them).

The controller's secant amplifies an ulp in any estimate it steers by, so
the other float32 habits of the reference's compiled estimators are held
bit for bit here too: XLA's own log (and log2, and the PSNR's folded
`-10 log10`), and the order of the ZFP sample points' sum of squares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as r_est
from repro_torch.core import estimator as p_est

#: every point of the 0.05 dB grid from 0 to 200 dB
GRID = (np.arange(4001) * 0.05).astype(np.float32)
#: seeded value ranges across the float32 span the estimators meet
VRS = np.exp(np.random.default_rng(17).uniform(-30.0, 30.0, 300)).astype(np.float32)


def _reference(eager: bool):
    fn = r_est.sz_delta_for_psnr
    return fn if eager else jax.jit(fn)


def _port(psnr, vr, eager: bool):
    if eager:
        return p_est.sz_delta_for_psnr(psnr, vr, eager=True).numpy()
    return p_est.sz_delta_for_psnr(psnr, vr).numpy()


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("eager", [False, True], ids=["compiled", "eager"])
def test_grid_at_unit_range(eager):
    want = _reference(eager)(jnp.asarray(GRID), jnp.float32(1.0))
    got = _port(torch.from_numpy(GRID), 1.0, eager)
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, f"differs at {GRID[bad][:10]} dB"


@pytest.mark.parametrize("eager", [False, True], ids=["compiled", "eager"])
def test_grid_at_seeded_ranges(eager):
    psnr = np.repeat(GRID[None], len(VRS), axis=0).reshape(-1)
    vr = np.repeat(VRS, len(GRID))
    want = _reference(eager)(jnp.asarray(psnr), jnp.asarray(vr))
    got = _port(torch.from_numpy(psnr), torch.from_numpy(vr), eager)
    bad = np.flatnonzero(_bits(got) != _bits(want))
    assert bad.size == 0, f"differs at (psnr, vr) {list(zip(psnr[bad][:5], vr[bad][:5]))}"


@pytest.mark.parametrize("eager", [False, True], ids=["compiled", "eager"])
def test_off_grid_psnr(eager):
    """Estimated PSNRs fall between grid points: the snap itself (PSNR * 20
    compiled, PSNR / 0.05 eager) must round as the reference's does."""
    rng = np.random.default_rng(5)
    psnr = rng.uniform(-20.0, 260.0, 50_000).astype(np.float32)
    vr = np.exp(rng.uniform(-30.0, 30.0, psnr.size)).astype(np.float32)
    want = _reference(eager)(jnp.asarray(psnr), jnp.asarray(vr))
    got = _port(torch.from_numpy(psnr), torch.from_numpy(vr), eager)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("form", ["mul", "div"])
def test_pow10_on_every_snapped_exponent(form):
    """`_pow10_f32` against the reference's float32 `10.0 ** y` on every
    exponent the two forms make from grid points -1000 to 1000 dB."""
    q = np.arange(-20000, 20001).astype(np.float32) * np.float32(0.05)
    y = (-q * np.float32(0.05)) if form == "mul" else (-q / np.float32(20.0))
    want = jax.jit(lambda t: 10.0 ** t)(jnp.asarray(y))
    got = p_est._pow10_f32(torch.from_numpy(y))
    bad = np.flatnonzero(_bits(got.numpy()) != _bits(want))
    assert bad.size == 0, f"differs at y = {y[bad][:10]}"


def test_pow10_special_values():
    y = np.array([np.inf, -np.inf, np.nan, 60.0, -60.0, 38.5, -45.0, 0.0], np.float32)
    want = np.asarray(jax.jit(lambda t: 10.0 ** t)(jnp.asarray(y)))
    got = p_est._pow10_f32(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_three_grid_points_the_parent_missed():
    """81.40, 99.75 and 131.10 dB: there glibc's powf rounds up where the
    correctly rounded 10^y rounds down."""
    pts = np.array([81.40, 99.75, 131.10], np.float32)
    want = jax.jit(r_est.sz_delta_for_psnr)(jnp.asarray(pts), jnp.float32(1.0))
    got = p_est.sz_delta_for_psnr(torch.from_numpy(pts), 1.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # 10^y rounded once from double misses all three by one ulp
    y = -(np.round(pts * np.float32(20.0)) * np.float32(0.05)) * np.float32(0.05)
    pow10 = (10.0 ** y.astype(np.float64)).astype(np.float32)
    rounded_once = np.float32(np.sqrt(12.0)) * pow10
    assert (_bits(rounded_once) != _bits(want)).all()


# ---------------------------------------------------------------------------
# The other float32 habits of the reference's compiled estimators
# ---------------------------------------------------------------------------


def _log_inputs():
    rng = np.random.default_rng(11)
    return np.concatenate([
        np.exp(rng.uniform(-87.0, 88.0, 400_000)), rng.uniform(0.0, 1.0, 100_000),
        2.0 ** np.arange(-126, 128), np.arange(1, 70_000),
        (2.0 ** np.arange(-60, 60)) * (1 + 2.0**-23), (2.0 ** np.arange(-60, 60)) * (1 - 2.0**-24),
        [0.0, -0.0, np.inf, -1.0, np.nan, 1e-40, 3.4e38],
    ]).astype(np.float32)


@pytest.mark.parametrize("name", ["log", "log2", "neg10_log10"])
def test_xla_log_family(name):
    """XLA's float32 log (its own polynomial, with FMAs), log2 and the
    folded `-10 * log10(max(x, 1e-60))` of the PSNR estimates, bit for bit
    on 600k values, powers of two and their neighbours, and specials."""
    x = _log_inputs()
    ref_fn, port_fn = {
        "log": (jnp.log, p_est._xla_log),
        "log2": (jnp.log2, p_est._xla_log2),
        "neg10_log10": (lambda v: -10.0 * jnp.log10(jnp.maximum(v, 1e-60)), p_est._neg10_log10),
    }[name]
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(x)))
    got = port_fn(torch.from_numpy(x)).numpy()
    same = (want == got) | (np.isnan(want) & np.isnan(got))
    assert same.all(), f"differs at {x[~same][:8]}"


def _packed(nd, seed):
    rng = np.random.default_rng(seed)
    sizes = [96, 160, 64, 170]  # small tensors: no intra-op threads
    blocks = [np.cumsum(rng.standard_normal((n,) + (4,) * nd), axis=-1) * s
              for n, s in zip(sizes, (1.0, 30.0, 1e-3, 5.0))]
    seg = np.concatenate([np.full(n, f, np.int32) for f, n in enumerate(sizes)])
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    vr = np.array([np.ptp(b) for b in blocks], np.float32)
    return np.concatenate(blocks).astype(np.float32), seg, bounds, vr


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_zfp_psnr_bit_for_bit_in_every_mode(nd):
    """`estimate_zfp_many`'s PSNR equals the reference's compiled one bit
    for bit at 24 bounds in the PSNR-only mode, and at four of them in
    'exact' and 'model' too (the mode only decides the bit count)."""
    blocks, seg, bounds, vr = _packed(nd, nd)
    ref = jax.jit(lambda *a: r_est.estimate_zfp_many(*a).psnr)
    args = [torch.from_numpy(a) for a in (blocks, seg, bounds)]
    for i, rel in enumerate(np.logspace(-7, -1, 24)):
        eb = (rel * vr).astype(np.float32)
        want = np.asarray(ref(blocks, seg, bounds, eb, vr))
        for mode in ("psnr", "exact", "model") if i % 6 == 0 else ("psnr",):
            e = p_est.estimate_zfp_many(*args, torch.from_numpy(eb), torch.from_numpy(vr), mode=mode)
            assert (e.bitrate is None) == (mode == "psnr")
            np.testing.assert_array_equal(e.psnr.numpy(), want, err_msg=f"{mode} at {rel}")
