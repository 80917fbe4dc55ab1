"""The metric layer: the port's `core/quality.py` against the reference on
the CPU.

The statistics and transforms are float64 numpy in both packages, so they
must agree exactly on the same inputs; `stats_from_field` gathers its
sample through the port's estimator and must give the reference's sample.
`metric_curves` rides `estimate_curves`, whose sweep follows the
reference's float32 roundings, so its curves agree to float32 rounding.
"""

import numpy as np
import pytest

from repro.core import quality as r_qual
from repro_torch.core import quality as p_qual

METRICS = ("ssim", "correlation", "ks")


def _field(kind, seed, scale=1.0):
    """The field families of the reference's quality property tests."""
    rng = np.random.default_rng(seed)
    if kind == "white2d":
        x = scale * rng.standard_normal((96, 96))
    elif kind == "walk2d":
        x = np.cumsum(scale * rng.standard_normal((96, 96)), axis=0)
    elif kind == "walk3d":
        x = np.cumsum(scale * rng.standard_normal((16, 32, 32)), axis=2)
    else:  # ramp3d
        x = np.linspace(0.0, 4.0 * scale, 12 * 32 * 32).reshape(12, 32, 32)
        x = x + 0.05 * scale * rng.standard_normal(x.shape)
    return x.astype(np.float32)


KINDS = ["white2d", "walk2d", "walk3d", "ramp3d"]


def _stats_pair(kind, seed, scale=1.0):
    x = _field(kind, seed, scale)
    return r_qual.stats_from_field(x), p_qual.stats_from_field(x, device="cpu")


def test_constants_match_reference():
    for name in ("MODE_METRIC", "METRIC_MODES", "TOLERANCE", "LOSSLESS_VALUE", "SSIM_K2",
                 "KS_MAX_SAMPLES", "PSNR_EQ_RANGE", "KS_GRID_RANGE", "KS_GRID_POINTS",
                 "KS_TARGET_MARGIN"):
        assert getattr(p_qual, name) == getattr(r_qual, name), name


@pytest.mark.parametrize("kind", KINDS)
def test_stats_from_field_match_reference(kind):
    """The sample the port gathers (on the device, then copied) is the
    reference's host sample: variance, range and sorted values exact."""
    want, got = _stats_pair(kind, 3, 2.0)
    assert got.var == want.var and got.vr == want.vr
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("kind", KINDS)
def test_quantization_curves_match_reference(kind):
    want, got = _stats_pair(kind, 5)
    for w, g in zip(want._quant_curves(), got._quant_curves()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nd", [2, 3])
def test_stats_from_blocks_match_reference(nd):
    rng = np.random.default_rng(nd)
    blocks = rng.standard_normal((7000,) + (5,) * nd).astype(np.float32)
    want = r_qual.stats_from_blocks(blocks, nd, 7.5)
    got = p_qual.stats_from_blocks(blocks, nd, 7.5)
    assert (got.var, got.vr) == (want.var, want.vr)
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", KINDS)
def test_inversion_layer_matches_reference(metric, kind):
    """equivalent_psnr, metric_from_psnr and the mse transforms exact on
    targets across each metric's range."""
    want, got = _stats_pair(kind, 9)
    targets = {"ssim": [0.5, 0.9, 0.97, 0.999], "correlation": [0.9, 0.995, 0.99999],
               "ks": [0.01, 0.05, 0.1, 0.3]}[metric]
    for t in targets:
        assert p_qual.equivalent_psnr(metric, t, got) == r_qual.equivalent_psnr(metric, t, want)
    for ps in (10.0, 35.5, 60.0, 90.0, float("inf")):
        assert p_qual.metric_from_psnr(metric, ps, got) == r_qual.metric_from_psnr(metric, ps, want)
    mse = np.logspace(-12, 1, 17) * want.var
    np.testing.assert_array_equal(p_qual.psnr_from_mse(mse, got.vr), r_qual.psnr_from_mse(mse, want.vr))
    np.testing.assert_array_equal(p_qual.mse_from_psnr([20.0, 60.0], got.vr),
                                  r_qual.mse_from_psnr([20.0, 60.0], want.vr))
    np.testing.assert_array_equal(p_qual.ssim_from_mse(mse, got.var, got.vr),
                                  r_qual.ssim_from_mse(mse, want.var, want.vr))
    np.testing.assert_array_equal(p_qual.correlation_from_mse(mse, got.var),
                                  r_qual.correlation_from_mse(mse, want.var))
    for m in mse[::4]:
        assert p_qual.ks_from_mse(got, m) == r_qual.ks_from_mse(want, m)
        assert p_qual.ssim_from_mse_sampled(got, m) == r_qual.ssim_from_mse_sampled(want, m)
    assert p_qual.mse_for_ssim(0.97, got.var, got.vr) == r_qual.mse_for_ssim(0.97, want.var, want.vr)
    assert p_qual.mse_for_correlation(0.995, got.var) == r_qual.mse_for_correlation(0.995, want.var)
    assert p_qual.mse_for_ks(got, 0.07) == r_qual.mse_for_ks(want, 0.07)
    assert p_qual.mse_for_ssim_sampled(got, 0.97) == r_qual.mse_for_ssim_sampled(want, 0.97)


def test_ssim_inversion_counterexample_matches_reference_values():
    """At the counterexample the reference's own property test reports
    (seed 9183, scale 1.0, var_frac 0.125) the sampled SSIM inversion is
    not a round trip; the port gives the reference's values there."""
    want, got = _stats_pair("walk2d", 9183, 1.0)
    mse = 0.125 * want.var
    s_w, s_g = r_qual.ssim_from_mse_sampled(want, mse), p_qual.ssim_from_mse_sampled(got, mse)
    assert s_g == s_w
    assert p_qual.mse_for_ssim_sampled(got, s_g) == r_qual.mse_for_ssim_sampled(want, s_w)


def test_gap_lossless_and_errors_match_reference():
    for metric in METRICS:
        for a, t in ((0.9, 0.95), (0.2, 0.1), (1.0, 1.0)):
            assert p_qual.metric_gap(metric, a, t) == r_qual.metric_gap(metric, a, t)
    for mode in ("fixed_ssim", "fixed_correlation", "fixed_ks", "fixed_psnr", "fixed_ratio"):
        assert p_qual.lossless_metric(mode) == r_qual.lossless_metric(mode)
    stats = p_qual.stats_from_field(_field("walk2d", 1), device="cpu")
    with pytest.raises(ValueError, match="unknown quality metric"):
        p_qual.metric_from_psnr("psnr", 40.0, stats)


@pytest.mark.parametrize("metric", METRICS)
def test_measured_metrics_match_reference(metric):
    rng = np.random.default_rng(4)
    a = _field("walk3d", 2)
    for b in (a + 0.01 * rng.standard_normal(a.shape).astype(np.float32), a.copy(),
              np.zeros_like(a), np.round(a)):
        assert p_qual.measured_metric(metric, a, b) == r_qual.measured_metric(metric, a, b)


@pytest.mark.parametrize("kind", ["walk2d", "walk3d"])
def test_metric_curves_match_reference(kind):
    """Twelve bounds on one 2-D and one 3-D field: the estimator curves the
    metric curves ride on, then every metric curve of both codecs."""
    x = _field(kind, 21, 3.0)
    bounds = np.logspace(-4, 0, 12) * float(np.ptp(x))
    want = r_qual.metric_curves(x, bounds)
    got = p_qual.metric_curves(x, bounds, device="cpu")
    assert set(got) == set(want)
    for key in ("br_sz", "br_zfp"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=5e-3, err_msg=key)
    for key in ("psnr_sz", "psnr_zfp", "psnr_sz_measured"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=key)
    for metric in METRICS:
        for codec in ("sz", "zfp"):
            key = f"{metric}_{codec}"
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)
