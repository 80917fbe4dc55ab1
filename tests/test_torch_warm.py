"""The warm path (`select_many` / `solve_many` / `compress_pytree` with a
`DecisionCache`) against the live reference on CPU JAX.

Every contract of the reference's `tests/test_decision_cache.py` but the
shard-local one runs through both packages side by side: the cache events
must be equal, the port's warm decisions must equal its cold ones (`==`,
bit for bit), and the port's decisions must agree with the reference's
within the golden-suite tolerances (codec equal, eb_sz to a relative 1e-5,
rates to 5e-3 bits/value). The 3-step trajectory of
`tests/test_golden_decisions.py::test_golden_warm_trajectory` runs through
both packages on its suite, and a cache written by either package hits in
the other (the fingerprints are digest-equal).
"""

import json

import numpy as np
import pytest

import repro.core as rc
from repro.core import controller as r_ctl
from repro.core import selector as r_sel
from repro.core.decision_cache import DecisionCache as RCache
from repro.core.policy import Policy as RPolicy
from repro_torch.core import api as p_api
from repro_torch.core import controller as p_ctl
from repro_torch.core import interop
from repro_torch.core import selector as p_sel
from repro_torch.core.decision_cache import CacheEntry, DecisionCache
from repro_torch.core.policy import Policy

EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3
CPU = dict(device="cpu")


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    smooth2d = np.cumsum(rng.standard_normal((96, 96)).astype(np.float32), axis=0)
    ramp3d = (
        np.linspace(0.0, 4.0, 16 * 48 * 48, dtype=np.float32).reshape(16, 48, 48)
        + 0.05 * rng.standard_normal((16, 48, 48)).astype(np.float32)
    )
    rough1d = rng.standard_normal((4096,)).astype(np.float32)
    return [smooth2d, ramp3d, rough1d]


NAMES = ["smooth2d", "ramp3d", "rough1d"]
POL, RPOL = Policy.fixed_accuracy(eb_rel=1e-3), RPolicy.fixed_accuracy(eb_rel=1e-3)
MODES = {
    "fixed_psnr": 60.0, "fixed_ratio": 8.0, "fixed_ssim": 0.97,
    "fixed_correlation": 0.995, "fixed_ks": 0.1,
}


def _close_sel(p, r, what=""):
    assert p.codec == r.codec, what
    assert p.eb_abs == pytest.approx(r.eb_abs, rel=1e-6), what
    assert p.eb_sz == pytest.approx(r.eb_sz, rel=EB_SZ_RTOL), what
    assert p.br_sz == pytest.approx(r.br_sz, abs=BR_ATOL), what
    assert p.br_zfp == pytest.approx(r.br_zfp, abs=BR_ATOL), what


def _select_both(fields, pcache, rcache, pol=POL, rpol=RPOL, names=NAMES):
    p = p_sel.select_many(fields, policy=pol, cache=pcache, names=names, **CPU)
    r = r_sel.select_many(fields, policy=rpol, cache=rcache, names=names)
    for a, b, n in zip(p, r, names):
        _close_sel(a, b, n)
    assert pcache.events == rcache.events
    return p


# -- the golden trajectory -------------------------------------------------


def test_warm_trajectory_matches_reference():
    """Step 0 cold-populates, step 1 replays identical data (all hits),
    step 2 scale-jumps one field and ulp-nudges another (both invalidate);
    the events and decisions of both packages agree at every step, and the
    events are the frozen golden's."""
    from benchmarks.common import atm_suite, hurricane_suite, nyx_suite
    from repro.core import estimator as r_est

    fields = {}
    fields.update({f"atm/{k}": v for k, v in atm_suite(8, size=(96, 192)).items()})
    fields.update({f"hur/{k}": v for k, v in hurricane_suite(6, size=(16, 48, 48)).items()})
    fields.update({f"nyx/{k}": v for k, v in nyx_suite(4, size=(32, 32, 32)).items()})
    names = list(fields)
    pcache, rcache = DecisionCache(), RCache()
    jump, nudge = names[0], names[1]
    with open("tests/golden/warm_trajectory.json") as f:
        golden = json.load(f).get(f"table{int(r_est.TABLE_BITS_PER_SYMBOL)}")
    steps = []
    for step in range(3):
        cur = {n: v.copy() for n, v in fields.items()}
        if step == 2:
            cur[jump] = cur[jump] * 1000.0
            a = cur[nudge]
            a.flat[0] = np.nextafter(a.flat[0], np.float32(np.inf))
        pcache.reset_stats()
        rcache.reset_stats()
        sels = _select_both(list(cur.values()), pcache, rcache, names=names)
        steps.append(sels)
        for n in names:
            event = pcache.events.get(n, "degenerate")
            if golden is not None:
                assert event == golden[f"step{step}/{n}"]["event"], (step, n)
    assert steps[1] == steps[0]
    assert pcache.events[jump] == pcache.events[nudge] == "invalidated"
    assert sum(e == "hit" for e in pcache.events.values()) == len(names) - 2


# -- warm == cold ----------------------------------------------------------


def test_warm_decisions_bit_identical_to_cold():
    fields = _fields()
    cold = p_sel.select_many(fields, policy=POL, **CPU)
    pc, rcache = DecisionCache(), RCache()
    first = _select_both(fields, pc, rcache)
    warm = _select_both(fields, pc, rcache)
    assert first == cold and warm == cold
    assert pc.stats()["hits"] == len(fields)
    assert all(pc.events[n] == "hit" for n in NAMES)


def test_warm_bytes_bit_identical_to_cold():
    tree = dict(zip(NAMES, _fields()))
    cold = p_api.compress_pytree(tree, POL, **CPU)
    cache = DecisionCache()
    p_api.compress_pytree(tree, POL, cache=cache, **CPU)
    warm = p_api.compress_pytree(tree, POL, cache=cache, **CPU)
    ref = rc.compress_pytree(tree, policy=RPOL)
    for name in cold.fields:
        assert warm.fields[name].data == cold.fields[name].data
        assert warm.fields[name].codec == cold.fields[name].codec == ref.fields[name].codec
    assert cache.stats()["hits"] == len(tree)


@pytest.mark.parametrize("mode", ["fixed_accuracy", *MODES])
def test_warm_solutions_bit_identical_to_cold(mode):
    fields = _fields()
    if mode == "fixed_accuracy":
        pol, rpol = POL, RPOL
    else:
        pol, rpol = getattr(Policy, mode)(MODES[mode]), getattr(RPolicy, mode)(MODES[mode])
    cold = p_ctl.solve_many(fields, pol, **CPU)
    pc, rcache = DecisionCache(), RCache()
    first = p_ctl.solve_many(fields, pol, cache=pc, names=NAMES, **CPU)
    warm = p_ctl.solve_many(fields, pol, cache=pc, names=NAMES, **CPU)
    r_ctl.solve_many(fields, rpol, cache=rcache, names=NAMES)
    ref = r_ctl.solve_many(fields, rpol, cache=rcache, names=NAMES)
    assert first == cold and warm == cold
    assert pc.events == rcache.events and pc.stats()["hits"] == len(fields)
    for a, b, n in zip(warm, ref, NAMES):
        _close_sel(a.selection, b.selection, n)
        assert a.on_target == b.on_target, n


def test_epsilon_perturbation_invalidates_and_matches_subset_cold():
    fields = _fields()
    pc, rcache = DecisionCache(), RCache()
    _select_both(fields, pc, rcache)
    bumped = [fields[0].copy(), fields[1], fields[2]]
    bumped[0][0, 0] = np.nextafter(bumped[0][0, 0], np.float32(np.inf))
    warm = _select_both(bumped, pc, rcache)
    assert pc.events == {"smooth2d": "invalidated", "ramp3d": "hit", "rough1d": "hit"}
    # the re-decided field ran alone: the same as a solo cold call
    assert warm[0] == p_sel.select_many([bumped[0]], policy=POL, **CPU)[0]
    cold = p_sel.select_many(fields, policy=POL, **CPU)
    assert warm[1] == cold[1] and warm[2] == cold[2]


# -- invalidation triggers -------------------------------------------------


def test_scale_jump_invalidates():
    fields = _fields()
    pc, rcache = DecisionCache(), RCache()
    _select_both(fields, pc, rcache)
    jumped = [fields[0] * 1000.0, fields[1], fields[2]]
    warm = _select_both(jumped, pc, rcache)
    assert pc.events["smooth2d"] == "invalidated"
    assert warm[0] == p_sel.select_many([jumped[0]], policy=POL, **CPU)[0]
    assert warm[0].eb_abs == pytest.approx(1000.0 * 1e-3 * np.ptp(fields[0]), rel=1e-5)


def test_nan_injection_rederives_raw_never_stale():
    fields = _fields()
    pc, rcache = DecisionCache(), RCache()
    first = _select_both(fields, pc, rcache)
    assert first[0].codec != "raw"
    poisoned = [fields[0].copy(), fields[1], fields[2]]
    poisoned[0][3, 3] = np.nan
    warm = _select_both(poisoned, pc, rcache)
    assert warm[0].codec == "raw"
    recovered = _select_both(fields, pc, rcache)
    assert recovered[0] == first[0] and pc.events["smooth2d"] == "hit"


@pytest.mark.parametrize("change", ["dtype", "shape", "policy", "solve_mode"])
def test_key_changes_invalidate(change):
    """A dtype, shape or policy change misses the key (a cached fixed_psnr
    entry never serves fixed_accuracy); the re-decision equals a cold
    call."""
    fields = _fields()
    pc, rcache = DecisionCache(), RCache()
    pol, rpol = POL, RPOL
    if change == "solve_mode":
        p_ctl.solve_many(fields, Policy.fixed_psnr(60.0), cache=pc, names=NAMES, **CPU)
        r_ctl.solve_many(fields, RPolicy.fixed_psnr(60.0), cache=rcache, names=NAMES)
    else:
        _select_both(fields, pc, rcache)
    new = list(fields)
    if change == "dtype":
        new[0] = fields[0].astype(np.float64)
    elif change == "shape":
        new[0] = fields[0].reshape(48, 192)
    elif change == "policy":
        pol, rpol = Policy.fixed_accuracy(eb_rel=1e-5), RPolicy.fixed_accuracy(eb_rel=1e-5)
    warm = _select_both(new, pc, rcache, pol=pol, rpol=rpol)
    changed = NAMES if change in ("policy", "solve_mode") else NAMES[:1]
    assert all(pc.events[n] == "invalidated" for n in changed)
    assert all(pc.events[n] == "hit" for n in NAMES if n not in changed)
    cold = p_sel.select_many([new[NAMES.index(n)] for n in changed], policy=pol, **CPU)
    assert [warm[NAMES.index(n)] for n in changed] == cold
    if change == "policy":  # the cache now holds the tighter decisions
        assert _select_both(new, pc, rcache, pol=pol, rpol=rpol) == warm
        assert pc.events["smooth2d"] == "hit"


# -- tolerance > 0 and warm_start ------------------------------------------


def test_tolerance_band_accepts_tiny_drift_rejects_jumps():
    fields = _fields()
    pc, rcache = DecisionCache(tolerance=0.05), RCache(tolerance=0.05)
    first = _select_both(fields, pc, rcache)
    drifted = [fields[0] * (1.0 + 1e-7), fields[1], fields[2]]
    warm = _select_both(drifted, pc, rcache)
    assert pc.events["smooth2d"] == "hit" and warm[0] == first[0]
    _select_both([fields[0] * 3.0, fields[1], fields[2]], pc, rcache)
    assert pc.events["smooth2d"] == "invalidated"


def test_warm_start_resolve_matches_reference():
    """warm_start seeds the secant from the stale bound: the re-solve still
    lands on target, and on the reference's solution."""
    fields = _fields()
    pc, rcache = DecisionCache(warm_start=True), RCache(warm_start=True)
    p_ctl.solve_many(fields, Policy.fixed_psnr(60.0), cache=pc, names=NAMES, **CPU)
    r_ctl.solve_many(fields, RPolicy.fixed_psnr(60.0), cache=rcache, names=NAMES)
    drifted = [f * 1.3 for f in fields]
    warm = p_ctl.solve_many(drifted, Policy.fixed_psnr(60.0), cache=pc, names=NAMES, **CPU)
    ref = r_ctl.solve_many(drifted, RPolicy.fixed_psnr(60.0), cache=rcache, names=NAMES)
    assert pc.events == rcache.events
    assert all(e == "invalidated" for e in pc.events.values())
    for sol, r, n in zip(warm, ref, NAMES):
        _close_sel(sol.selection, r.selection, n)
        if sol.selection.codec != "raw" and sol.on_target:
            assert sol.est_psnr == pytest.approx(60.0, abs=1.0)


# -- persistence and interop -----------------------------------------------


def test_manifest_roundtrip_preserves_bit_identity():
    fields = _fields()
    cache = DecisionCache()
    cold = p_sel.select_many(fields, policy=POL, cache=cache, names=NAMES, **CPU)
    reloaded = DecisionCache()
    reloaded.load_manifest(json.loads(json.dumps(cache.to_manifest())))
    warm = p_sel.select_many(fields, policy=POL, cache=reloaded, names=NAMES, **CPU)
    assert warm == cold and reloaded.stats()["hits"] == len(fields)


@pytest.mark.parametrize("mode", ["fixed_accuracy", "fixed_psnr"])
def test_cache_crosses_between_packages(mode):
    """A reference cache record loads into the port and every field hits,
    replaying the reference's decision; and the other way round."""
    fields = _fields()
    rcache = RCache()
    if mode == "fixed_accuracy":
        r_sel.select_many(fields, policy=RPOL, cache=rcache, names=NAMES)
    else:
        r_ctl.solve_many(fields, RPolicy.fixed_psnr(60.0), cache=rcache, names=NAMES)
    record = json.loads(json.dumps(rcache.to_manifest()))
    pc = interop.decision_cache_from_manifest(record)
    if mode == "fixed_accuracy":
        got = p_sel.select_many(fields, policy=POL, cache=pc, names=NAMES, **CPU)
    else:
        got = [s.selection for s in p_ctl.solve_many(
            fields, Policy.fixed_psnr(60.0), cache=pc, names=NAMES, **CPU)]
    assert all(pc.events[n] == "hit" for n in NAMES)
    for g, n in zip(got, NAMES):
        assert g == interop.selection_from_reference(record_entry(record, n)["selection"])
    back = RCache()
    back.load_manifest(json.loads(json.dumps(pc.to_manifest())))
    if mode == "fixed_accuracy":
        r_sel.select_many(fields, policy=RPOL, cache=back, names=NAMES)
    else:
        r_ctl.solve_many(fields, RPolicy.fixed_psnr(60.0), cache=back, names=NAMES)
    assert all(back.events[n] == "hit" for n in NAMES)


def record_entry(record, name):
    return next(e for e in record["entries"] if e["name"] == name)


# -- API misuse ------------------------------------------------------------


def test_cache_requires_names():
    fields = _fields()
    with pytest.raises(ValueError, match="names"):
        p_sel.select_many(fields, policy=POL, cache=DecisionCache(), **CPU)
    with pytest.raises(ValueError, match="names"):
        p_sel.select_many(fields, policy=POL, cache=DecisionCache(), names=["one"], **CPU)
    with pytest.raises(ValueError, match="names"):
        p_ctl.solve_many(fields, Policy.fixed_psnr(60.0), cache=DecisionCache(), **CPU)


def test_entry_roundtrips_selection_and_solution():
    fields = _fields()
    cache = DecisionCache()
    sols = p_ctl.solve_many(fields, Policy.fixed_psnr(60.0), cache=cache, names=NAMES, **CPU)
    e = cache.entries["smooth2d"]
    assert isinstance(e, CacheEntry)
    assert e.to_selection() == sols[0].selection
    assert e.to_solution() == sols[0]
