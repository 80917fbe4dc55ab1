"""Quality metrics as Policy targets: SSIM, correlation and KS.

Port of `repro.core.quality` (DESIGN.md §7.4); pure numpy, as in the
reference, apart from `stats_from_field` and `metric_curves`, which gather
their sample through the port's estimator and controller on `device`.

The controller inverts the rate/PSNR estimators; many consumers of
scientific data hold domain quality contracts instead: structural
similarity, Pearson correlation, distribution shape. This module maps a
candidate error bound to a predicted metric value for both codecs, using
only the residual models plus the halo-block sample, with zero trial
compressions:

* Both codecs' decompression error is additive, roughly independent of the
  data, and of known variance: SZ's integer-Lorenzo rounding error is
  uniform in [-delta/2, delta/2], and ZFP's truncation error variance comes
  from the sampled-point PSNR. So every metric here is a function of the
  error variance ``mse``, read off the PSNR curves the controller sweeps.
* SSIM (single window, zero-mean error): under independent error the
  contrast/structure product is ``(2 var + C2) / (2 var + mse + C2)`` with
  ``C2 = (K2 * VR)^2``. Quantization error is signal-correlated at coarse
  bins, so the solver reads SSIM off the measured quantization curve
  (`ssim_from_mse_sampled`: exact for SZ, conservative for ZFP); the closed
  form is the fine-bound limit.
* Pearson correlation: ``rho = 1 / sqrt(1 + mse / var)``, closed form.
* KS statistic: sample-measured. The prequantized SZ reconstructs exactly
  ``delta * round(x / delta)``, whose value-CDF shift is first order in
  delta, so a per-field ``mse <-> KS`` curve is measured by quantizing the
  sorted sample over a log grid of bin sizes (`FieldQualityStats.ks_curve`).

`equivalent_psnr` turns a metric target into a per-field PSNR target, which
the controller solves with its fixed_psnr machinery. The statistics are
float64 numpy on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: Policy mode -> metric key.
MODE_METRIC = {
    "fixed_ssim": "ssim",
    "fixed_correlation": "correlation",
    "fixed_ks": "ks",
}
METRIC_MODES = tuple(MODE_METRIC)

#: Documented achievement tolerances (|achieved - target|) per metric; the
#: bench gate (`quality_target_accuracy`) and `TargetSolution.on_target`
#: both read these.
TOLERANCE = {"ssim": 0.02, "correlation": 0.005, "ks": 0.02}

#: Metric value of a lossless (raw) encode.
LOSSLESS_VALUE = {"ssim": 1.0, "correlation": 1.0, "ks": 0.0}

#: SSIM stabilizer constant K2 of Wang et al., scaled by the field's value
#: range; C1 (luminance) drops out because the error is zero-mean.
SSIM_K2 = 0.03
_SSIM_K1 = 0.01

#: Cap on the per-field sorted sample the KS estimator keeps (deterministic
#: spatial stride over the Stage-I block values, so every path sees the
#: same sample). ECDF resolution ~1/sqrt(n) = 0.008 at the cap — well under
#: the 0.02 KS tolerance.
KS_MAX_SAMPLES = 16384

#: Equivalent-PSNR clamp for metric inversion: below, the rate estimator's
#: own floor takes over; above, the solve lands on raw anyway.
PSNR_EQ_RANGE = (5.0, 180.0)

#: log2(delta / VR) grid the per-field mse<->KS curve is measured on: from
#: far below any solvable bound up to "one bin swallows the range".
KS_GRID_RANGE = (-40.0, 2.0)
KS_GRID_POINTS = 64

#: fixed_ks inversion safety margin: the block sample of a spatially
#: correlated field reads the value ECDF with an effective sample size well
#: below the point count, so the measured KS curve can sit a few thousandths
#: under the full-field one. The contract is a one-sided ceiling — solving
#: for (target - margin) trades a little rate for staying under it.
KS_TARGET_MARGIN = 0.005

_TINY = 1e-30


def _ecdf_sup(x_sorted: np.ndarray, y_sorted: np.ndarray) -> float:
    """Two-sample KS statistic of two pre-sorted samples."""
    if x_sorted.size == 0 or y_sorted.size == 0:
        return 0.0
    t = np.concatenate([x_sorted, y_sorted])
    fx = np.searchsorted(x_sorted, t, side="right") / x_sorted.size
    fy = np.searchsorted(y_sorted, t, side="right") / y_sorted.size
    return float(np.max(np.abs(fx - fy)))


# ---------------------------------------------------------------------------
# Sufficient statistics
# ---------------------------------------------------------------------------


@dataclass
class FieldQualityStats:
    """Per-field metric sufficient statistics, computed once from the same
    Stage-I halo-block sample the rate/PSNR estimators use (so the warm
    path's psum-reconciled moments fingerprint also guards these — see
    `core/sharded.py`)."""

    var: float  # sample variance sigma_x^2 (float64)
    vr: float  # value range
    values: np.ndarray  # sorted sample values, float64, <= KS_MAX_SAMPLES
    _curves: tuple[np.ndarray, np.ndarray, np.ndarray] | None = field(
        default=None, init=False, repr=False
    )

    def _quant_curves(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(mse_grid, ks_grid, ssim_grid): measured error variance, KS
        statistic and global SSIM of `delta * round(values / delta)` over a
        log grid of bin sizes, each forced monotone (mse and KS
        non-decreasing, SSIM non-increasing) so target inversion by
        interpolation is well-posed. Computed lazily, once per field. SSIM
        is measured here rather than closed-form because quantization error
        is signal-CORRELATED at coarse bins (values pull toward bin
        centers: var(q) ~ var - mse, not var + mse), which depresses the
        contrast/structure term below the independent-error model; at fine
        bins the measured curve converges to the closed form."""
        if self._curves is None:
            v = self.values
            vr = max(self.vr, _TINY)
            c1 = (_SSIM_K1 * vr) ** 2
            c2 = (SSIM_K2 * vr) ** 2
            mx = float(v.mean()) if v.size else 0.0
            vx = float(v.var()) if v.size else 0.0
            deltas = vr * np.exp2(
                np.linspace(KS_GRID_RANGE[0], KS_GRID_RANGE[1], KS_GRID_POINTS)
            )
            mse = np.empty(KS_GRID_POINTS)
            ks = np.empty(KS_GRID_POINTS)
            ssim = np.empty(KS_GRID_POINTS)
            for i, d in enumerate(deltas):
                q = d * np.round(v / d)  # still sorted: round is monotone
                mse[i] = float(np.mean((v - q) ** 2)) if v.size else 0.0
                ks[i] = _ecdf_sup(v, q)
                if v.size:
                    my, vy = float(q.mean()), float(q.var())
                    cov = float(np.mean((v - mx) * (q - my)))
                    lum = (2.0 * mx * my + c1) / (mx * mx + my * my + c1)
                    ssim[i] = lum * (2.0 * cov + c2) / (vx + vy + c2)
                else:
                    ssim[i] = 1.0
            self._curves = (
                np.maximum.accumulate(mse),
                np.maximum.accumulate(ks),
                np.minimum.accumulate(ssim),
            )
        return self._curves

    def ks_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(mse_grid, ks_grid) of the measured quantization curve."""
        mse, ks, _ = self._quant_curves()
        return mse, ks

    def ssim_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(mse_grid, ssim_grid) of the measured quantization curve."""
        mse, _, ssim = self._quant_curves()
        return mse, ssim


def stats_from_blocks(blocks: np.ndarray, nd: int, vr: float) -> FieldQualityStats:
    """Statistics from a (n_blocks, 5, ..) halo-block batch (the halo row is
    zero-filled outside the domain, so only the 4^nd interior is sampled)."""
    b = np.asarray(blocks)
    if b.shape[1] == 5:  # strip the original-neighbor halo
        b = b[(slice(None),) + (slice(1, None),) * nd]
    v = b.astype(np.float64, copy=False).reshape(-1)
    var = float(np.var(v)) if v.size else 0.0
    if v.size > KS_MAX_SAMPLES:
        v = v[:: -(-v.size // KS_MAX_SAMPLES)]
    return FieldQualityStats(var=var, vr=float(vr), values=np.sort(v))


def stats_from_field(x, r_sp: float = 0.05, *, device=None) -> FieldQualityStats:
    """Statistics straight from a field (the curve helper's path); the
    solver uses `stats_from_blocks` on the blocks it already gathered. The
    sample is gathered on `device` (default the GPU) and copied to the
    host."""
    from .. import device as _device
    from . import estimator as est
    from .selector import _fold_ndim

    view = _fold_ndim(_device.as_f32(x, _device.resolve(device)))
    starts = est.block_starts(tuple(view.shape), r_sp)
    blocks = est.gather_blocks(view, starts, halo=True).cpu().numpy()
    vr = float(view.max() - view.min()) if view.numel() else 0.0
    return stats_from_blocks(blocks, view.ndim, vr)


# ---------------------------------------------------------------------------
# mse <-> PSNR <-> metric transforms (closed-form layer)
# ---------------------------------------------------------------------------


def mse_from_psnr(psnr_db, vr: float):
    """Error variance implied by a value-range-relative PSNR."""
    vr2 = max(float(vr), _TINY) ** 2
    return vr2 * 10.0 ** (-np.asarray(psnr_db, np.float64) / 10.0)


def psnr_from_mse(mse, vr: float):
    """Inverse of `mse_from_psnr` (clamped away from log(0))."""
    vr2 = max(float(vr), _TINY) ** 2
    return -10.0 * np.log10(np.maximum(np.asarray(mse, np.float64), _TINY * vr2) / vr2)


def ssim_from_mse(mse, var: float, vr: float):
    """Single-window SSIM under zero-mean INDEPENDENT additive error of
    variance `mse`: luminance = 1, contrast*structure =
    (2 var + C2) / (2 var + mse + C2). The closed-form/demo layer — the
    solver uses `ssim_from_mse_sampled`, which this curve upper-bounds."""
    c2 = (SSIM_K2 * max(float(vr), _TINY)) ** 2
    return (2.0 * var + c2) / (2.0 * var + np.asarray(mse, np.float64) + c2)


def mse_for_ssim(target: float, var: float, vr: float) -> float:
    """Invert `ssim_from_mse`: the error variance at which SSIM == target."""
    c2 = (SSIM_K2 * max(float(vr), _TINY)) ** 2
    return (2.0 * var + c2) * (1.0 - target) / max(target, _TINY)


def correlation_from_mse(mse, var: float):
    """Pearson correlation between a field and itself plus independent
    zero-mean error: rho = 1 / sqrt(1 + mse / var)."""
    return 1.0 / np.sqrt(1.0 + np.asarray(mse, np.float64) / max(var, _TINY))


def mse_for_correlation(target: float, var: float) -> float:
    """Invert `correlation_from_mse`."""
    t = min(max(target, _TINY), 1.0 - 1e-12)
    return var * (1.0 / (t * t) - 1.0)


# ---------------------------------------------------------------------------
# KS statistic (sample-measured layer)
# ---------------------------------------------------------------------------


def ks_from_mse(stats: FieldQualityStats, mse: float) -> float:
    """Predicted KS statistic at decompression-error variance `mse`, read
    off the measured per-field mse<->KS quantization curve (exact for the
    prequantized SZ codec; a conservative matched-mse surrogate for ZFP —
    module docstring)."""
    mse_g, ks_g = stats.ks_curve()
    return float(np.interp(mse, mse_g, ks_g))


def mse_for_ks(stats: FieldQualityStats, target: float) -> float:
    """Invert `ks_from_mse`: the error variance whose predicted KS hits
    `target` (interpolation on the monotone-forced measured curve)."""
    mse_g, ks_g = stats.ks_curve()
    if target <= ks_g[0]:
        return float(mse_g[0])
    return float(np.interp(target, ks_g, mse_g))


def ssim_from_mse_sampled(stats: FieldQualityStats, mse: float) -> float:
    """Predicted SSIM at error variance `mse`, read off the measured
    quantization curve. Exact for SZ (whose error IS the quantization
    error), conservative for ZFP: signal-correlated quantization depresses
    SSIM harder than ZFP's closer-to-independent truncation error, so the
    solve lands at or above target either way. Converges to
    `ssim_from_mse`'s closed form at fine bounds."""
    mse_g, _, ssim_g = stats._quant_curves()
    return float(np.interp(mse, mse_g, ssim_g))


def mse_for_ssim_sampled(stats: FieldQualityStats, target: float) -> float:
    """Invert `ssim_from_mse_sampled` on the monotone-forced curve."""
    mse_g, _, ssim_g = stats._quant_curves()
    if target >= ssim_g[0]:
        return float(mse_g[0])
    # ssim_g decreases with mse: reverse both for np.interp's ascending-x
    return float(np.interp(target, ssim_g[::-1], mse_g[::-1]))


# ---------------------------------------------------------------------------
# Metric <-> equivalent PSNR (the controller-facing layer)
# ---------------------------------------------------------------------------


def equivalent_psnr(metric: str, target: float, stats: FieldQualityStats) -> float:
    """The per-field PSNR target whose error variance achieves `target` on
    `metric` — the closed-form seed the §7 controller inversion runs on."""
    if metric == "ssim":
        mse = mse_for_ssim_sampled(stats, target)
    elif metric == "correlation":
        mse = mse_for_correlation(target, stats.var)
    elif metric == "ks":
        mse = mse_for_ks(stats, max(target - KS_TARGET_MARGIN, target * 0.5))
    else:  # pragma: no cover - guarded by Policy validation
        raise ValueError(f"unknown quality metric {metric!r}; one of {sorted(TOLERANCE)}")
    lo, hi = PSNR_EQ_RANGE
    return float(np.clip(psnr_from_mse(mse, stats.vr), lo, hi))


def metric_from_psnr(metric: str, psnr_db: float, stats: FieldQualityStats) -> float:
    """Predicted metric value at an achieved (estimated) PSNR."""
    if not np.isfinite(psnr_db):
        return LOSSLESS_VALUE[metric]
    mse = float(mse_from_psnr(psnr_db, stats.vr))
    if metric == "ssim":
        return ssim_from_mse_sampled(stats, mse)
    if metric == "correlation":
        return float(correlation_from_mse(mse, stats.var))
    if metric == "ks":
        return ks_from_mse(stats, mse)
    raise ValueError(f"unknown quality metric {metric!r}; one of {sorted(TOLERANCE)}")


def metric_gap(metric: str, achieved: float, target: float) -> float:
    """Signed violation of the contract: positive = target missed. SSIM and
    correlation are floors (overshoot is free quality), KS is a ceiling."""
    if metric == "ks":
        return achieved - target
    return target - achieved


def lossless_metric(mode: str) -> float | None:
    """`TargetSolution.est_metric` for a raw (lossless) selection; None for
    the non-metric modes."""
    m = MODE_METRIC.get(mode)
    return None if m is None else LOSSLESS_VALUE[m]


# ---------------------------------------------------------------------------
# Measured metrics (verification layer: benches, property tests, examples)
# ---------------------------------------------------------------------------


def measured_ssim(a, b) -> float:
    """Global (single-window) SSIM between original `a` and reconstruction
    `b`, with C1/C2 scaled by `a`'s value range."""
    x = np.asarray(a, np.float64).reshape(-1)
    y = np.asarray(b, np.float64).reshape(-1)
    vr = max(float(x.max() - x.min()), _TINY) if x.size else _TINY
    c1 = (_SSIM_K1 * vr) ** 2
    c2 = (SSIM_K2 * vr) ** 2
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(), y.var()
    cov = float(np.mean((x - mx) * (y - my)))
    lum = (2.0 * mx * my + c1) / (mx * mx + my * my + c1)
    cs = (2.0 * cov + c2) / (vx + vy + c2)
    return float(lum * cs)


def measured_correlation(a, b) -> float:
    """Pearson correlation coefficient (1.0 for a bit-exact or constant pair)."""
    x = np.asarray(a, np.float64).reshape(-1)
    y = np.asarray(b, np.float64).reshape(-1)
    if np.array_equal(x, y):
        return 1.0
    sx, sy = x.std(), y.std()
    if sx <= 0.0 or sy <= 0.0:
        return 0.0
    return float(np.mean((x - x.mean()) * (y - y.mean())) / (sx * sy))


def measured_ks(a, b) -> float:
    """Two-sample KS statistic between the value distributions of `a` and `b`."""
    x = np.sort(np.asarray(a, np.float64).reshape(-1))
    y = np.sort(np.asarray(b, np.float64).reshape(-1))
    return _ecdf_sup(x, y)


_MEASURED = {
    "ssim": measured_ssim,
    "correlation": measured_correlation,
    "ks": measured_ks,
}


def measured_metric(metric: str, a, b) -> float:
    """Dispatch to the measured implementation of `metric`."""
    return _MEASURED[metric](a, b)


# ---------------------------------------------------------------------------
# Metric curves (demo / property-test surface)
# ---------------------------------------------------------------------------


def metric_curves(
    x, bounds, r_sp: float = 0.05, transform: str = "zfp", *, device=None
) -> dict:
    """Predicted metric-vs-error-bound curves for both codecs over an
    ascending `bounds` grid, built on `controller.estimate_curves` (run on
    `device`, default the GPU) and forced monotone (SSIM/correlation
    non-increasing in eb, KS non-decreasing) so target inversion can rely
    on monotonicity even where the sampled PSNR staircase wiggles."""
    from .controller import estimate_curves

    curves = estimate_curves(x, bounds, r_sp=r_sp, transform=transform, device=device)
    stats = stats_from_field(x, r_sp, device=device)
    # SZ's quality follows the measured quantization error, ZFP's the
    # sampled truncation error — both forced monotone non-increasing first
    ps_sz = np.minimum.accumulate(np.asarray(curves["psnr_sz_measured"], np.float64))
    ps_zfp = np.minimum.accumulate(np.asarray(curves["psnr_zfp"], np.float64))
    out = dict(curves)
    for codec, ps in (("sz", ps_sz), ("zfp", ps_zfp)):
        mse = mse_from_psnr(ps, stats.vr)
        ssim = np.array([ssim_from_mse_sampled(stats, float(m)) for m in mse])
        corr = correlation_from_mse(mse, stats.var)
        ks = np.array([ks_from_mse(stats, float(m)) for m in mse])
        out[f"ssim_{codec}"] = np.minimum.accumulate(ssim)
        out[f"correlation_{codec}"] = np.minimum.accumulate(corr)
        out[f"ks_{codec}"] = np.maximum.accumulate(ks)
    return out
