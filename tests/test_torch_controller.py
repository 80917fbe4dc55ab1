"""The quality-target controller: the port's `solve_many` / `solve` /
`estimate_curves` / `compress` / `compress_pytree` under every target mode
against the live reference on the CPU.

Suites: the golden suite's 18 fields and the 36-field suite of
tests/test_select_many.py. Modes: fixed_psnr(60), fixed_ratio(6),
fixed_ratio(3) (where the reference gives three fields to ZFP),
fixed_ssim(0.97), fixed_correlation(0.995) and fixed_ks(0.1), plus ZFP-only
allowlists at fixed_psnr(60) and fixed_ssim(0.999), which drive the ZFP
branches the default solves seldom take. Tolerances per field: codec and
on_target equal, eb_abs and eb_sz to 1e-4 relative, est_bitrate to 5e-3
bits/value, a finite est_psnr to 1e-3 dB, est_metric to 1e-4. fixed_ratio is
held to the live `repro.core.solve_many`, not to tests/golden/fixed_ratio.json.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

import repro.core as R
from repro.core import controller as r_ctl
from repro.core.policy import Policy as RPolicy
from repro.core.policy import PolicySet as RPolicySet
from repro_torch.core import CompressedField, Policy, PolicySet, compress, compress_pytree, decompress
from repro_torch.core import controller as p_ctl
from repro_torch.core import decompress_pytree, encode_with_selection, estimate_curves, interop
from repro_torch.core import select_many, solve, solve_many
from repro_torch.core import quality as p_qual
from repro_torch.core.decision_cache import DecisionCache
from test_select_many import _field_suite
from test_torch_select import FIELDS

EB_RTOL = 1e-4
BR_ATOL = 5e-3
PSNR_ATOL = 1e-3
METRIC_ATOL = 1e-4

SUITES = {"golden": FIELDS, "suite36": _field_suite()}
#: id -> (policy constructor name, target, codec allowlist or None)
MODES = {
    "psnr60": ("fixed_psnr", 60.0, None),
    "ratio6": ("fixed_ratio", 6.0, None),
    "ratio3": ("fixed_ratio", 3.0, None),
    "ssim0.97": ("fixed_ssim", 0.97, None),
    "corr0.995": ("fixed_correlation", 0.995, None),
    "ks0.1": ("fixed_ks", 0.1, None),
    "psnr60-zfp": ("fixed_psnr", 60.0, ("zfp",)),
    "ssim0.999-zfp": ("fixed_ssim", 0.999, ("zfp",)),
}


def _policies(mode_id):
    name, target, codecs = MODES[mode_id]
    kw = {} if codecs is None else {"codecs": codecs}
    return getattr(RPolicy, name)(target, **kw), getattr(Policy, name)(target, **kw)


@functools.lru_cache(maxsize=None)
def _solves(suite, mode_id):
    fields = list(SUITES[suite].values())
    r_pol, p_pol = _policies(mode_id)
    return R.solve_many(fields, r_pol), solve_many(fields, p_pol, device="cpu")


def _assert_close(got, want, name=""):
    gs, ws = got.selection, want.selection
    assert gs.codec == ws.codec, f"{name}: {gs.codec} vs {ws.codec}"
    assert got.on_target == want.on_target, name
    assert (got.mode, got.target) == (want.mode, want.target), name
    assert gs.eb_abs == pytest.approx(ws.eb_abs, rel=EB_RTOL), name
    assert gs.eb_sz == pytest.approx(ws.eb_sz, rel=EB_RTOL), name
    assert got.est_bitrate == pytest.approx(want.est_bitrate, abs=BR_ATOL), name
    if math.isfinite(want.est_psnr):
        assert got.est_psnr == pytest.approx(want.est_psnr, abs=PSNR_ATOL), name
    else:
        assert got.est_psnr == want.est_psnr, name
    if want.est_metric is None:
        assert got.est_metric is None, name
    else:
        assert got.est_metric == pytest.approx(want.est_metric, abs=METRIC_ATOL), name


@pytest.mark.parametrize("mode_id", list(MODES))
@pytest.mark.parametrize("suite", list(SUITES))
def test_solve_many_matches_reference(suite, mode_id):
    want, got = _solves(suite, mode_id)
    assert len(got) == len(want)
    for name, g, w in zip(SUITES[suite], got, want):
        _assert_close(g, w, f"{suite}/{name}")


@pytest.mark.parametrize(
    "suite,mode_id,n_zfp,n_on",
    [("suite36", "ratio3", 3, 36), ("suite36", "psnr60-zfp", 36, 0),
     ("suite36", "ssim0.999-zfp", 36, 36)],
)
def test_zfp_branches_are_exercised(suite, mode_id, n_zfp, n_on):
    """The reference's ZFP-branch counts on these solves, which the port
    matches field for field above."""
    want, got = _solves(suite, mode_id)
    for sols in (want, got):
        assert sum(s.selection.codec == "zfp" for s in sols) == n_zfp
        assert sum(bool(s.on_target) for s in sols) == n_on


def test_solve_single_field_matches_reference():
    x = SUITES["suite36"]["f02"]
    want = R.solve(x, RPolicy.fixed_psnr(45.0))
    got = solve(x, Policy.fixed_psnr(45.0), device="cpu")
    _assert_close(got, want)


@pytest.mark.parametrize("name", ["atm/ATM_00", "hur/V_3"])
def test_estimate_curves_match_reference(name):
    """Ten bounds in one call: the candidate loop gives the reference's
    vmapped values at each bound (the measured and ZFP PSNRs and both rates
    bit for bit; the model PSNR to float32 rounding)."""
    x = FIELDS[name]
    bounds = np.logspace(-6, -1, 10) * float(np.ptp(x))
    want = R.estimate_curves(x, bounds)
    got = estimate_curves(x, bounds, device="cpu")
    assert set(got) == set(want)
    for key in ("br_sz", "br_zfp", "psnr_zfp", "psnr_sz_measured"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["psnr_sz"], want["psnr_sz"], rtol=0, atol=PSNR_ATOL)


def _secant_pair(seed, ge):
    rng = np.random.default_rng(seed)
    F = 64
    x0 = rng.uniform(-20, 0, F)
    t = rng.uniform(30, 90, F) if ge else float(rng.uniform(2, 10))
    slope = -6.02 if ge else -1.0
    clamp = r_ctl.PSNR_SLOPE_CLAMP if ge else r_ctl.RATE_SLOPE_CLAMP
    g0 = (np.asarray(t) + slope * rng.uniform(-3, 3, F)).astype(np.float32)
    args = (x0, g0, t, slope, clamp)
    kw = dict(ge=ge, x_lo=x0 - 30.0, x_hi=x0 + 1.0)
    return r_ctl._Secant(*args, **kw), p_ctl._Secant(*args, **kw), rng


@pytest.mark.parametrize("ge", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_secant_matches_reference(seed, ge):
    """Four propose/step rounds on seeded staircase-like curves: proposals,
    brackets and feasible-best probes equal."""
    rs, ps, rng = _secant_pair(seed, ge)
    for _ in range(4):
        xr, xp = rs.propose(), ps.propose()
        np.testing.assert_array_equal(xp, xr)
        noise = rng.uniform(-2, 2, len(xr))
        g = (rs.t + (-6.02 if ge else -1.0) * (xr - rs.xc) + noise).astype(np.float32)
        g[::7] = rs.gc[::7]  # flat staircase steps
        rs.step(xr, g)
        ps.step(xp, g)
        for attr in ("blo", "bhi", "x_best", "g_best", "xc", "gc"):
            np.testing.assert_array_equal(getattr(ps, attr), getattr(rs, attr), err_msg=attr)
        np.testing.assert_array_equal(ps.found, rs.found)


def _members(fields, mode, target, r_sp=0.05):
    r_res, p_res = [None] * len(fields), [None] * len(fields)
    rg = r_ctl._build_solve_members(fields, range(len(fields)), r_res, mode, target, r_sp)
    pg = p_ctl._build_solve_members(fields, range(len(fields)), p_res, mode, target, r_sp, "cpu")
    return rg, pg, r_res, p_res


@pytest.mark.parametrize("mode,target", [("fixed_psnr", 55.0), ("fixed_ratio", 5.0),
                                         ("fixed_ssim", 0.98)])
def test_warm_seeds_through_solve_groups(mode, target):
    """Per-member warm seeds (log2 SZ bin, log2 ZFP bound; NaN = cold)
    through `_solve_groups`: the port lands where the reference does."""
    fields = [FIELDS[n] for n in ("atm/ATM_01", "atm/ATM_02", "hur/W_4", "nyx/dark_matter_density")]
    rg, pg, r_res, p_res = _members(fields, mode, target)
    lv = [math.log2(float(np.ptp(x))) for x in fields]
    warm = {0: (lv[0] - 12.0, lv[0] - 11.0), 2: (lv[2] - 9.5, float("nan")),
            3: (float("nan"), lv[3] - 14.0)}
    r_ctl._solve_groups(rg, r_res, mode, target, 3, 0.05, "zfp", warm=warm)
    p_ctl._solve_groups(pg, p_res, mode, target, 3, 0.05, "zfp", warm=warm)
    for i, (g, w) in enumerate(zip(p_res, r_res)):
        _assert_close(g, w, f"field {i}")
    assert p_ctl._warm_seeds(None, 1.0, 2.0, 0.0, 3.0) == (1.0, 2.0)


@pytest.mark.parametrize("mode_id", ["psnr60", "ratio6", "ks0.1"])
def test_monster_field_strided_down(monkeypatch, mode_id):
    """A field over the batch's block cap is strided down to it and stays
    in the batched sweep, in both packages (the cap made small in both)."""
    cap = lambda nd: 256  # noqa: E731
    monkeypatch.setattr(r_ctl, "_max_batch_blocks", cap)
    monkeypatch.setattr(p_ctl, "_max_batch_blocks", cap)
    fields = [FIELDS["atm/ATM_03"], FIELDS["atm/ATM_04"], FIELDS["hur/U_2"], FIELDS["nyx/temperature"]]
    r_pol, p_pol = _policies(mode_id)
    _, pg, _, _ = _members(fields, "fixed_psnr", 60.0)
    assert max(len(m.blocks) for ms in pg.values() for m in ms) <= 256
    want = R.solve_many(fields, r_pol)
    got = solve_many(fields, p_pol, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, f"field {i}")


def _degenerate_fields():
    rng = np.random.default_rng(3)
    nan = rng.standard_normal((32, 32)).astype(np.float32)
    nan[5, 5] = np.nan
    return [
        np.ones(16, np.float32),                       # too small
        np.full((64, 64), 2.5, np.float32),            # constant
        nan,                                           # NaN-poisoned
        rng.standard_normal((64, 64)).astype(np.float32),  # raw by rate at 200 dB
        np.zeros((0, 8), np.float32),                  # empty
    ]


@pytest.mark.parametrize("mode_id", ["psnr60", "ratio6", "ssim0.97", "corr0.995", "ks0.1"])
def test_degenerate_and_raw_fallbacks(mode_id):
    r_pol, p_pol = _policies(mode_id)
    fields = _degenerate_fields()
    want = R.solve_many(fields, r_pol)
    got = solve_many(fields, p_pol, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_close(g, w, f"field {i}")
        assert g.selection.vr == w.selection.vr or (
            np.isnan(g.selection.vr) and np.isnan(w.selection.vr)
        )
    assert [s.selection.codec for s in got[:3]] == ["raw"] * 3
    hot_r = R.solve_many(fields[3:4], RPolicy.fixed_psnr(200.0))[0]
    hot_p = solve_many(fields[3:4], Policy.fixed_psnr(200.0), device="cpu")[0]
    assert hot_p.selection.codec == "raw"
    _assert_close(hot_p, hot_r)


def test_fixed_accuracy_delegates_and_modes_raise():
    x = FIELDS["atm/ATM_05"]
    want = R.solve_many([x], RPolicy.fixed_accuracy(eb_rel=1e-3))[0]
    got = solve_many([x], Policy.fixed_accuracy(eb_rel=1e-3), device="cpu")[0]
    _assert_close(got, want)
    with pytest.raises(ValueError, match="nothing to solve"):
        solve_many([x], Policy.raw(), device="cpu")
    with pytest.raises(TypeError):
        solve_many([x], 60.0, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        solve_many([x], Policy.fixed_psnr(60.0), target_psnr=60.0, device="cpu")


def test_legacy_mode_string_solves_the_same():
    x = FIELDS["atm/ATM_06"]
    with pytest.warns(DeprecationWarning):
        legacy = solve_many([x], "fixed_psnr", target_psnr=50.0, device="cpu")[0]
    _assert_close(legacy, solve_many([x], Policy.fixed_psnr(50.0), device="cpu")[0])


def test_warm_cache_raises_naming_item_8():
    """The warm path (item 8) is ported: a cache replays the cold solve and
    the cold bytes; `compress_pytree(sharded=True)` (item 14a) on plain
    tensors takes the gather path and gives the unsharded bytes."""
    x = FIELDS["atm/ATM_00"]
    cache = DecisionCache()
    cold = solve_many([x], Policy.fixed_psnr(60.0), device="cpu")
    for _ in range(2):
        assert solve_many([x], Policy.fixed_psnr(60.0), cache=cache, names=["a"], device="cpu") == cold
    assert cache.events == {"a": "hit"}
    tree_cache = DecisionCache()
    want = compress_pytree({"a": x}, Policy.fixed_psnr(60.0), device="cpu")
    for _ in range(2):
        got = compress_pytree({"a": x}, Policy.fixed_psnr(60.0), cache=tree_cache, device="cpu")
        assert got.fields["a"].data == want.fields["a"].data
    assert tree_cache.events == {"a": "hit"}
    sharded = compress_pytree({"a": x}, Policy.fixed_psnr(60.0), sharded=True, device="cpu")
    segs = sharded.fields["a"].segments
    assert [(s.start, s.stop) for s in segs] == [((0, 0), tuple(x.shape))]
    assert sharded.fields["a"].codec == want.fields["a"].codec
    assert segs[0].data == want.fields["a"].data
    with pytest.raises(ValueError, match="repro_torch.core.solve_many"):
        select_many([x], policy=Policy.fixed_psnr(60.0), device="cpu")


def test_target_solution_from_reference_drives_port_encoder():
    """A reference solve, carried across as plain values, encodes in the
    port to the reference's own bytes."""
    x = FIELDS["hur/P_5"]
    sol = R.solve(x, RPolicy.fixed_ssim(0.97))
    port_sol = interop.target_solution_from_reference(dataclasses.asdict(sol))
    assert port_sol == p_ctl.TargetSolution(
        interop.selection_from_reference(dataclasses.asdict(sol.selection)), sol.mode,
        sol.target, sol.est_psnr, sol.est_bitrate, sol.on_target, sol.est_metric,
    )
    cf = encode_with_selection(x, port_sol.selection, device="cpu")
    assert cf.data == R.encode_with_selection(x, sol.selection).data


# ---------------------------------------------------------------------------
# compress / compress_pytree under every mode, decoded by both packages
# ---------------------------------------------------------------------------


def _psnr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).reshape(a.shape)
    vr = float(a.max() - a.min())
    mse = float(np.mean((a - b) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(vr * vr / mse)


def _assert_contract(pol, x, rec, nbytes, sol_on_target=True):
    """The decoded field meets its policy: PSNR within 1 dB, the stream's
    ratio within 10%, a metric one-sided within quality.TOLERANCE."""
    if pol.mode == "fixed_psnr":
        assert abs(_psnr(x, rec) - pol.target_psnr) <= 1.0
    elif pol.mode == "fixed_ratio":
        assert abs(x.size * 4 / nbytes / pol.target_ratio - 1.0) <= 0.10
    elif sol_on_target:
        metric = p_qual.MODE_METRIC[pol.mode]
        target = getattr(pol, f"target_{metric}")
        achieved = p_qual.measured_metric(metric, x, np.asarray(rec).reshape(x.shape))
        assert p_qual.metric_gap(metric, achieved, target) <= p_qual.TOLERANCE[metric]


CONTRACT_MODES = ["psnr60", "ratio6", "ssim0.97", "corr0.995", "ks0.1"]


def _contract_fields():
    rng = np.random.default_rng(0)
    n = 256
    xx, yy = np.meshgrid(np.linspace(0, 6, n), np.linspace(0, 6, n))
    noisy = np.sin(4 * xx) * np.cos(3 * yy) + 0.05 * rng.standard_normal((n, n))
    walk3d = np.cumsum(rng.standard_normal((16, 64, 64)), axis=1)
    return {"noisy": noisy.astype(np.float32), "walk3d": walk3d.astype(np.float32)}


@pytest.mark.parametrize("device_encode", [False, True])
@pytest.mark.parametrize("mode_id", CONTRACT_MODES)
def test_compress_matches_reference_and_meets_contract(mode_id, device_encode):
    """The port's `compress` picks the reference's selection and writes its
    bytes (the device encoder held to the reference's host coder); each
    package decodes the other's stream within the contract."""
    r_pol, p_pol = _policies(mode_id)
    for name, x in _contract_fields().items():
        want = R.compress(x, r_pol)
        got = compress(x, p_pol, device_encode=device_encode, device="cpu")
        assert got.codec == want.codec, name
        gs, ws = got.selection, want.selection
        assert gs.eb_abs == pytest.approx(ws.eb_abs, rel=EB_RTOL), name
        assert gs.eb_sz == pytest.approx(ws.eb_sz, rel=EB_RTOL), name
        if gs == ws and not device_encode:
            assert got.data == want.data, name
        rec_p = decompress(got, device="cpu").numpy()
        rec_r = np.asarray(R.decompress(R.CompressedField(
            got.codec, got.data, got.shape, got.dtype, want.selection)))
        np.testing.assert_array_equal(rec_r.reshape(x.shape), rec_p.reshape(x.shape))
        rec_x = decompress(_port_field(want), device="cpu").numpy()
        np.testing.assert_array_equal(rec_x.reshape(x.shape),
                                      np.asarray(R.decompress(want)).reshape(x.shape))
        on = solve(x, p_pol, device="cpu").on_target
        _assert_contract(p_pol, x, rec_p, len(got.data), on)


def _port_field(cf):
    """A reference `CompressedField` as the port's (plain values)."""
    sel = interop.selection_from_reference(dataclasses.asdict(cf.selection))
    return CompressedField(cf.codec, cf.data, tuple(cf.shape), cf.dtype, sel)


def _mixed_tree():
    fields = _contract_fields()
    rng = np.random.default_rng(8)
    return {
        "psnr": {"a": fields["noisy"], "b": fields["walk3d"]},
        "ratio": {"a": fields["noisy"] * 3.0, "b": fields["walk3d"][:, ::-1].copy()},
        "ssim": {"a": np.cumsum(rng.standard_normal((128, 128)), 0).astype(np.float32)},
        "corr": {"a": fields["noisy"] + 1.0},
        "ks": {"a": fields["walk3d"] * 0.5},
        "acc": {"a": fields["noisy"] - 2.0},
        "step": np.arange(8, dtype=np.int32),
        "const": np.full((64, 64), 2.5, np.float32),
    }


def _rules(P):
    return [
        ("psnr/*", P.fixed_psnr(60.0)),
        ("ratio/*", P.fixed_ratio(6.0)),
        ("ssim/*", P.fixed_ssim(0.97)),
        ("corr/*", P.fixed_correlation(0.995)),
        ("ks/*", P.fixed_ks(0.1)),
    ]


def test_compress_pytree_mixed_policyset_matches_reference():
    """One PolicySet with a rule per mode over a fixed_accuracy default:
    the port's per-leaf selections are the reference's, each package
    decodes the other's tree, and every leaf meets its contract."""
    tree = _mixed_tree()
    r_set = RPolicySet(rules=_rules(RPolicy), default=RPolicy.fixed_accuracy(eb_rel=1e-4))
    p_set = PolicySet(rules=_rules(Policy), default=Policy.fixed_accuracy(eb_rel=1e-4))
    want = R.compress_pytree(tree, r_set, workers=0)
    got = compress_pytree(tree, p_set, workers=0, device="cpu")
    assert list(got.fields) == list(want.fields)
    for name, cf in got.fields.items():
        w = want.fields[name]
        assert cf.codec == w.codec, name
        if cf.selection is not None:
            assert cf.selection.eb_abs == pytest.approx(w.selection.eb_abs, rel=EB_RTOL), name
            if cf.selection == w.selection:
                assert cf.data == w.data, name
    out_p = decompress_pytree(got, device="cpu")
    out_r = R.decompress_pytree(want)
    for group in ("psnr", "ratio", "ssim", "corr", "ks", "acc"):
        for leaf, x in tree[group].items():
            name = f"{group}/{leaf}"
            rec = out_p[group][leaf].numpy()
            pol = p_set.resolve(name)
            if pol.mode == "fixed_accuracy":
                assert np.abs(rec - x).max() <= got.fields[name].selection.eb_abs * 1.001
            else:
                on = solve(x, pol, device="cpu").on_target
                _assert_contract(pol, x, rec, got.fields[name].nbytes, on)
            np.testing.assert_array_equal(
                rec.reshape(x.shape), np.asarray(out_r[group][leaf]).reshape(x.shape))
    np.testing.assert_array_equal(out_p["step"].numpy(), tree["step"])
    np.testing.assert_array_equal(out_p["const"].numpy(), tree["const"])
