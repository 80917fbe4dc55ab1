"""`core/predictor.py` against `repro.core.predictor` on CPU JAX.

The same fields go through both packages' `_build_select_members` and
`stats_for_members`: the fingerprint digests must be equal (a cache written
by either package hits in the other), the value range and the sampled
min/max and IQR equal, and the float32 moments equal to a relative 1e-4:
the per-block sums of 16 or 64 terms run in torch's order, not XLA's, and
a field's moment is the difference of two float32 prefix sums over the
whole batch, which turns those ulps into up to 1.0e-5 of a small field's
moment (the sparse field here; the others within 4e-7). Fed the same
`FieldStats`, the host models (`confidence`, `predict_curves`,
`predict_selection`) are equal.
`select_many_predicted` routes every field alike and decides within the
golden-suite tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.common import atm_suite, hurricane_suite
from repro.core import predictor as r_pred
from repro.core import selector as r_sel
from repro_torch.core import predictor as p_pred
from repro_torch.core import selector as p_sel

CODECS = ("sz", "zfp", "raw")
MOMENT_RTOL = 1e-4
EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3


def _fields():
    rng = np.random.default_rng(0)
    out = dict(atm_suite(2, size=(180, 360)))
    out.update({f"hur/{k}": v for k, v in hurricane_suite(3, size=(20, 50, 50)).items()})
    out["walk2d"] = np.cumsum(rng.standard_normal((96, 96)), 0).astype(np.float32)
    out["noise1d"] = rng.standard_normal(4096).astype(np.float32)
    out["spiky"] = np.where(rng.random((64, 64)) < 0.01, 50.0, 0.0).astype(np.float32)
    out["const"] = np.full((32, 32), 1.5, np.float32)
    return out


FIELDS = _fields()


def _stats_both(eb_rel=1e-3, r_sp=0.05):
    arrs = list(FIELDS.values())
    res_r, res_p = [None] * len(arrs), [None] * len(arrs)
    gr = r_sel._build_select_members(arrs, range(len(arrs)), res_r, None, eb_rel, r_sp, "zfp", CODECS)
    gp = p_sel._build_select_members(
        arrs, range(len(arrs)), res_p, None, eb_rel, r_sp, "zfp", CODECS, torch.device("cpu")
    )
    assert sorted(gr) == sorted(gp)
    out = []
    for nd in gr:
        assert [m[0] for m in gr[nd]] == [m[0] for m in gp[nd]]
        out += zip(r_pred.stats_for_members(nd, gr[nd], r_sp),
                   p_pred.stats_for_members(nd, gp[nd], r_sp))
    return out


STATS = _stats_both()


@pytest.mark.parametrize("k", range(len(STATS)))
def test_stats_and_fingerprint_equal_reference(k):
    (sa, fa), (sb, fb) = STATS[k]
    assert fb["digest"] == fa["digest"]
    for key in ("vr", "size", "n_blocks", "smin", "smax", "iqr", "nd", "r_sp"):
        assert getattr(sb, key) == getattr(sa, key), key
    for key in ("ra1", "rv2", "rk4", "vv2"):
        assert getattr(sb, key) == pytest.approx(getattr(sa, key), rel=MOMENT_RTOL, abs=1e-30)
    assert set(fb) == set(fa)
    for key in ("kind", "vr", "size", "n", "smin", "smax"):
        assert fb[key] == fa[key], key


def test_fingerprint_of_equals_reference():
    rng = np.random.default_rng(3)
    for shape in ((7, 5, 5), (3, 5, 5, 5), (11, 5)):
        halo = rng.standard_normal(shape).astype(np.float32)
        args = (float(np.float32(2.5)), 4096, 0.05)
        assert p_pred.fingerprint_of(halo, *args) == r_pred.fingerprint_of(halo, *args)
    # a one-ulp change moves the digest in both
    bumped = halo.copy()
    bumped.flat[0] = np.nextafter(bumped.flat[0], np.float32(np.inf))
    assert p_pred.fingerprint_of(bumped, *args) != p_pred.fingerprint_of(halo, *args)


@pytest.mark.parametrize("k", range(len(STATS)))
def test_host_models_equal_reference(k):
    """Fed the reference's own FieldStats, the port's numpy models give the
    reference's numbers exactly."""
    (sa, _), _ = STATS[k]
    sp = p_pred.FieldStats(**dataclasses.asdict(sa))
    assert p_pred.confidence(sp) == r_pred.confidence(sa)
    ebs = np.geomspace(1e-6, 1e-1, 9) * max(sa.vr, 1e-30)
    ca, cb = r_pred.predict_curves(sa, ebs), p_pred.predict_curves(sp, ebs)
    assert set(cb) == set(ca)
    for key in ca:
        assert np.array_equal(np.asarray(cb[key]), np.asarray(ca[key])), key
    for eb in ebs[::3]:
        a = r_pred.predict_selection(sa, float(eb), CODECS)
        b = p_pred.predict_selection(sp, float(eb), CODECS)
        assert dataclasses.asdict(b) == dataclasses.asdict(a)


def test_select_many_predicted_routes_and_decisions():
    arrs = list(FIELDS.values())
    sr, rr = r_pred.select_many_predicted(arrs, eb_rel=1e-3)
    sp, rp = p_pred.select_many_predicted(arrs, eb_rel=1e-3, device="cpu")
    assert rp == rr
    assert set(rr) >= {"predicted", "sampled", "degenerate"}
    for name, a, b in zip(FIELDS, sr, sp):
        assert b.codec == a.codec, name
        assert b.eb_sz == pytest.approx(a.eb_sz, rel=EB_SZ_RTOL), name
        assert b.br_sz == pytest.approx(a.br_sz, abs=BR_ATOL), name
        assert b.br_zfp == pytest.approx(a.br_zfp, abs=BR_ATOL), name


def test_select_many_predicted_argument_errors():
    from repro_torch.core import Policy

    x = [FIELDS["walk2d"]]
    with pytest.raises(ValueError, match="fixed_accuracy policy"):
        p_pred.select_many_predicted(x, policy=Policy.fixed_psnr(60.0), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        p_pred.select_many_predicted(
            x, eb_rel=1e-3, policy=Policy.fixed_accuracy(), device="cpu"
        )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 16, 64, 100, 1023, 4096, 65537])
def test_iqr_from_order_statistics_equals_np_percentile(n):
    """The residual IQR from four order statistics (sorted on the device)
    and numpy's interpolation step equals `np.percentile` on the whole
    array, also with ties, before and after the division by vr."""
    from repro_torch.core.predictor import _iqr, _percentile_ranks

    rng = np.random.default_rng(n)
    for kind in ("normal", "ties", "tiny"):
        d = rng.standard_normal(n).astype(np.float32)
        if kind == "ties":
            d = np.round(d * 2).astype(np.float32)
        elif kind == "tiny":
            d = (d * 1e-30).astype(np.float32)
        vr = float(np.float32(rng.uniform(0.1, 10.0)))
        q75, q25 = np.percentile(d / max(vr, 1e-30), [75.0, 25.0])
        prev, nxt, gamma = _percentile_ranks(n)
        ranked = torch.sort(torch.from_numpy(d)).values.numpy()
        vals = ranked[np.concatenate([prev, nxt])] / max(vr, 1e-30)
        assert _iqr(vals[:2], vals[2:], gamma) == float(q75 - q25), kind
