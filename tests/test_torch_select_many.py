"""The batched engine: the port's `estimate_sz_many` and `select_many`
against the live reference on the CPU.

Decisions are held to the golden tolerances (tests/test_golden_decisions.py)
for the same batch composition: the codec equal, eb_sz to 1e-5 relative,
the estimated rates to 5e-3 bits/value. The suites are the golden suite's
fields (as tests/test_torch_select.py builds them) at eb_rel 1e-3 and the
36-field suite of tests/test_select_many.py at eb_rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import estimator as r_est
from repro.core import selector as r_sel
from repro_torch.core import Policy
from repro_torch.core import estimator as p_est
from repro_torch.core import selector as p_sel
from test_select_many import _field_suite
from test_torch_select import FIELDS

EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3
SUITES = {
    "golden": (FIELDS, 1e-3),
    "suite36": (_field_suite(), 1e-4),
}


def _assert_same_decisions(got, want, names):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert g.codec == w.codec, f"{name}: {g.codec} vs {w.codec}"
        assert g.eb_abs == pytest.approx(w.eb_abs, rel=1e-6), name
        assert g.eb_sz == pytest.approx(w.eb_sz, rel=EB_SZ_RTOL), name
        assert g.br_sz == pytest.approx(w.br_sz, abs=BR_ATOL), name
        assert g.br_zfp == pytest.approx(w.br_zfp, abs=BR_ATOL), name
        assert (g.vr == w.vr) or (np.isnan(g.vr) and np.isnan(w.vr)), name
        assert g.r_sp == w.r_sp


def _packed_batch(fields, r_sp=0.05):
    """A reference-built packed halo batch of the fields of one rank."""
    halos = [r_est.gather_blocks_np(x, r_est.block_starts(x.shape, r_sp), halo=True)
             for x in fields]
    seg = np.concatenate([np.full(len(h), f, np.int32) for f, h in enumerate(halos)])
    bounds = np.concatenate([[0], np.cumsum([len(h) for h in halos])]).astype(np.int32)
    vr = np.array([np.ptp(x) for x in fields], np.float32)
    size = np.array([x.size for x in fields], np.float32)
    return np.concatenate(halos), seg, bounds, vr, size


def _record_field_sums(monkeypatch, module):
    calls = []
    real = module.field_sums

    def spy(x, bounds):
        out = real(x, bounds)
        calls.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "field_sums", spy)
    return calls


@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("rel", [1e-4, 1e-2])
@pytest.mark.parametrize("n_pdf", [r_est.PDF_BINS, 33])
def test_estimate_sz_many_matches_reference(monkeypatch, rank, rel, n_pdf):
    """Rates within 5e-3 bits/value, PSNR equal; the escape counts and the
    int32 count columns (runs, singletons, doubletons) exact. A narrow PDF
    (n_pdf 33) makes escapes common."""
    fields = [x for x in FIELDS.values() if x.ndim == rank]
    halo, seg, bounds, vr, size = _packed_batch(fields)
    delta = (2.0 * rel * vr).astype(np.float32)
    args = (halo, seg, bounds, delta, vr, size)
    ref_calls = _record_field_sums(monkeypatch, r_est)
    want = r_est.estimate_sz_many(*map(jnp.asarray, args), n_pdf=n_pdf)
    port_calls = _record_field_sums(monkeypatch, p_est)
    got = p_est.estimate_sz_many(*map(torch.from_numpy, args), n_pdf=n_pdf)
    np.testing.assert_allclose(got.bitrate.numpy(), np.asarray(want.bitrate), atol=BR_ATOL)
    np.testing.assert_allclose(got.psnr.numpy(), np.asarray(want.psnr), rtol=1e-6)
    assert len(port_calls) == len(ref_calls) == 3  # escapes, |p log p|, counts
    for i in (0, 2):
        assert port_calls[i].dtype == ref_calls[i].dtype == np.int32
        np.testing.assert_array_equal(port_calls[i], ref_calls[i])
    if n_pdf == 33:
        assert port_calls[0].sum() > 0


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4097, 100_003])
def test_float_prefix_sums_follow_the_reference_order(n):
    """`field_sums` on float32 rows: bit for bit with the reference's
    compiled `jnp.cumsum` windows."""
    x = (np.random.default_rng(n).standard_normal(n) * 10.0).astype(np.float32)
    bounds = np.array([0, n // 3, n // 2, n], np.int32)
    want = jax.jit(r_est.field_sums)(jnp.asarray(x), jnp.asarray(bounds))
    got = p_est.field_sums(torch.from_numpy(x), torch.from_numpy(bounds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("suite", list(SUITES))
def test_select_many_matches_reference(suite):
    fields, rel = SUITES[suite]
    arrs = list(fields.values())
    want = R.select_many(arrs, eb_rel=rel)
    got = p_sel.select_many(arrs, eb_rel=rel, device="cpu")
    _assert_same_decisions(got, want, list(fields))
    if suite == "suite36":  # both codecs win somewhere
        assert {s.codec for s in got} >= {"sz", "zfp"}


@pytest.mark.parametrize("suite", list(SUITES))
def test_select_many_agrees_with_per_field_select(suite):
    """The batched decisions against the port's own per-field `select`
    (the bound reference's test_select_many.py holds between the two)."""
    fields, rel = SUITES[suite]
    many = p_sel.select_many(list(fields.values()), eb_rel=rel, device="cpu")
    for (name, x), m in zip(fields.items(), many):
        s = p_sel.select(x, eb_rel=rel, device="cpu")
        assert m.codec == s.codec, name
        assert m.br_sz == pytest.approx(s.br_sz, rel=2e-3, abs=1e-3), name
        assert m.br_zfp == pytest.approx(s.br_zfp, rel=2e-3, abs=1e-3), name


@pytest.mark.parametrize("max_fields,max_blocks", [(3, 10**6), (1024, 100), (2, 45)])
def test_batch_splits_match_reference(monkeypatch, max_fields, max_blocks):
    """Small caps, patched alike in both packages: batches cut by the field
    cap and by the block cap, and (at 45 blocks) the fields over the block
    cap through the per-field path."""
    for mod in (r_sel, p_sel):
        monkeypatch.setattr(mod, "MAX_BATCH_FIELDS", max_fields)
        monkeypatch.setattr(mod, "_max_batch_blocks", lambda nd: max_blocks)
    fields, rel = SUITES["suite36"]
    names = list(fields)[:8]
    arrs = [fields[k] for k in names]
    over = [len(r_est.block_starts(x.shape, 0.05)) > max_blocks for x in arrs]
    assert any(over) == (max_blocks == 45)
    want = R.select_many(arrs, eb_rel=rel)
    got = p_sel.select_many(arrs, eb_rel=rel, device="cpu")
    _assert_same_decisions(got, want, names)


def _degenerate_fields():
    rng = np.random.default_rng(5)
    nan = np.cumsum(rng.standard_normal((40, 40)), 0).astype(np.float32)
    nan[3, 7] = np.nan
    inf = nan.copy()
    inf[3, 7] = np.inf
    return [
        np.arange(10, dtype=np.float32),                         # too small
        np.full((64, 64), 3.0, dtype=np.float32),                # constant
        np.float32(1.5).reshape(()),                             # 0-d
        np.zeros((0, 8), np.float32),                            # empty
        np.ones((3, 100), np.float32) * np.arange(100),          # a dim < 4, folds
        nan,                                                     # NaN-poisoned
        inf,                                                     # inf-poisoned
        np.sin(np.linspace(0, 6, 4096)).astype(np.float32).reshape(64, 64),
        np.cumsum(rng.standard_normal((2, 3, 16, 16)), -1),      # 4-D float64
    ]


@pytest.mark.parametrize("bound", [{"eb_rel": 1e-3}, {"eb_abs": 0.01}])
def test_degenerate_fields_match_reference(bound):
    arrs = _degenerate_fields()
    want = R.select_many(arrs, **bound)
    got = p_sel.select_many(arrs, **bound, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.codec == w.codec, i
        assert g.eb_abs == pytest.approx(w.eb_abs, rel=1e-6, nan_ok=True), i
        if w.codec == "raw":
            assert (g.eb_sz, g.br_sz, g.br_zfp, g.psnr_target) == pytest.approx(
                (w.eb_sz, w.br_sz, w.br_zfp, w.psnr_target), nan_ok=True), i
    assert [got[i].codec for i in (0, 1, 2, 3, 5, 6)] == ["raw"] * 6


@pytest.mark.parametrize("codecs", [("sz", "raw"), ("zfp", "raw")])
def test_policy_argument_matches_reference(codecs):
    fields, rel = SUITES["golden"]
    names = list(fields)[:8]
    arrs = [fields[k] for k in names]
    want = R.select_many(arrs, policy=R.Policy.fixed_accuracy(eb_rel=rel, codecs=codecs))
    got = p_sel.select_many(
        arrs, policy=Policy.fixed_accuracy(eb_rel=rel, codecs=codecs), device="cpu")
    _assert_same_decisions(got, want, names)


def test_raw_only_allowlist_matches_reference():
    fields, rel = SUITES["golden"]
    arrs = list(fields.values())[:4]
    want = R.select_many(arrs, eb_rel=rel, codecs=("raw",))
    got = p_sel.select_many(arrs, eb_rel=rel, codecs=("raw",), device="cpu")
    _assert_same_decisions(got, want, list(fields)[:4])
    assert {s.codec for s in got} == {"raw"}


def test_select_many_argument_errors():
    x = [FIELDS["atm/ATM_00"]]
    for mod, pol in ((R, R.Policy), (p_sel, Policy)):
        kw = {} if mod is R else {"device": "cpu"}
        with pytest.raises(ValueError, match="fixed_accuracy policy"):
            mod.select_many(x, policy=pol.fixed_psnr(60.0), **kw)
        with pytest.raises(ValueError, match="not both"):
            mod.select_many(x, eb_rel=1e-3, policy=pol.fixed_accuracy(), **kw)
    # the warm path (ROADMAP item 8) is ported: a cache needs one name per
    # field, then replays the cold decision
    from repro_torch.core.decision_cache import DecisionCache

    cache = DecisionCache()
    with pytest.raises(ValueError, match="names"):
        p_sel.select_many(x, eb_rel=1e-3, cache=cache, device="cpu")
    cold = p_sel.select_many(x, eb_rel=1e-3, device="cpu")
    for _ in range(2):
        assert p_sel.select_many(x, eb_rel=1e-3, cache=cache, names=["a"], device="cpu") == cold
    assert cache.events == {"a": "hit"}


def test_tensor_fields_and_select_and_compress():
    """Tensors decide as arrays do; `select_and_compress` equals the
    reference's bytes for the same field."""
    fields, rel = SUITES["golden"]
    arrs = list(fields.values())[:6]
    from_arrays = p_sel.select_many(arrs, eb_rel=rel, device="cpu")
    from_tensors = p_sel.select_many([torch.from_numpy(a) for a in arrs], eb_rel=rel,
                                     device="cpu")
    assert from_arrays == from_tensors
    x = fields["atm/ATM_03"]
    ours = p_sel.select_and_compress(x, eb_rel=rel, device="cpu")
    theirs = R.select_and_compress(x, eb_rel=rel)
    assert (ours.codec, ours.data, ours.shape, ours.dtype) == (
        theirs.codec, theirs.data, theirs.shape, theirs.dtype)
