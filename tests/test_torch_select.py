"""Algorithm 1 for one field: the port's `select` against the reference.

On the golden suite's fields at eb_rel 1e-3 the port's decision must meet
the golden tolerances (tests/test_golden_decisions.py) against both the
live `repro.core.select` and the frozen `tests/golden/fixed_accuracy.json`
entry for this environment's Huffman-table cost: the codec equal, eb_sz to
1e-5 relative, the estimated rates to 5e-3 bits/value.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import atm_suite, hurricane_suite, nyx_suite
from repro.core import estimator as r_est
from repro.core import selector as r_sel
from repro_torch.core import estimator as p_est
from repro_torch.core import selector as p_sel

GOLDEN = Path(__file__).parent / "golden" / "fixed_accuracy.json"
EB_REL = 1e-3
EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3


def _suite_fields():
    """The golden suite's fields (same generators, sizes and names)."""
    fields = {}
    fields.update({f"atm/{k}": v for k, v in atm_suite(8, size=(96, 192)).items()})
    fields.update({f"hur/{k}": v for k, v in hurricane_suite(6, size=(16, 48, 48)).items()})
    fields.update({f"nyx/{k}": v for k, v in nyx_suite(4, size=(32, 32, 32)).items()})
    return fields


FIELDS = _suite_fields()


def _assert_decision(got, codec, eb, eb_sz, br_sz, br_zfp, name):
    assert got.codec == codec, f"{name}: {got.codec} vs {codec}"
    assert got.eb_abs == pytest.approx(eb, rel=1e-6), name
    assert got.eb_sz == pytest.approx(eb_sz, rel=EB_SZ_RTOL), name
    assert got.br_sz == pytest.approx(br_sz, abs=BR_ATOL), name
    assert got.br_zfp == pytest.approx(br_zfp, abs=BR_ATOL), name


@pytest.mark.parametrize("name", list(FIELDS))
def test_select_matches_reference(name):
    x = FIELDS[name]
    want = r_sel.select(x, eb_rel=EB_REL)
    got = p_sel.select(x, eb_rel=EB_REL, device="cpu")
    _assert_decision(got, want.codec, want.eb_abs, want.eb_sz, want.br_sz, want.br_zfp, name)
    assert got.vr == want.vr
    assert got.psnr_target == pytest.approx(want.psnr_target, abs=1e-3)


@pytest.mark.parametrize("name", list(FIELDS))
def test_select_matches_golden(name):
    golden = json.loads(GOLDEN.read_text())[f"table{int(p_est.TABLE_BITS_PER_SYMBOL)}"]
    want = golden[name]
    got = p_sel.select(FIELDS[name], eb_rel=EB_REL, device="cpu")
    _assert_decision(got, want["codec"], want["eb"], want["eb_sz"], want["br_sz"],
                     want["br_zfp"], name)


@pytest.mark.parametrize(
    "shape,fill",
    [((5,), "walk"), ((3, 100), "walk"), ((40, 40), "const"), ((40, 40), "nan"),
     ((2, 64, 64), "walk"), ((2, 3, 16, 16), "walk"), ((0, 8), "walk")],
)
def test_degenerate_and_folded_fields_match_reference(shape, fill):
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.standard_normal(shape), axis=-1).astype(np.float32)
    if fill == "const":
        x[...] = 2.5
    elif fill == "nan" and x.size:
        x.flat[7] = np.nan
    want = r_sel.select(x, eb_rel=EB_REL)
    got = p_sel.select(x, eb_rel=EB_REL, device="cpu")
    assert got.codec == want.codec
    assert got.eb_abs == pytest.approx(want.eb_abs, rel=1e-6, nan_ok=True)
    if want.codec == "raw":
        assert (got.br_sz, got.br_zfp) == (want.br_sz, want.br_zfp)
    assert tuple(p_sel._fold_ndim(x).shape) == tuple(r_sel._fold_ndim(x).shape)


@pytest.mark.parametrize("codecs", [("sz", "raw"), ("zfp", "raw"), ("raw",)])
def test_codec_allowlist_matches_reference(codecs):
    x = FIELDS["atm/ATM_03"]
    want = r_sel.select(x, eb_rel=EB_REL, codecs=codecs)
    got = p_sel.select(x, eb_rel=EB_REL, codecs=codecs, device="cpu")
    assert got.codec == want.codec
    for br_sz, br_zfp in [(3.0, 4.0), (4.0, 3.0), (40.0, 33.0), (5.0, 5.0)]:
        assert p_sel._pick_codec(br_sz, br_zfp, codecs) == r_sel._pick_codec(br_sz, br_zfp, codecs)


@pytest.mark.parametrize("shape", [(96, 192), (16, 48, 48), (2048,), (33, 17)])
@pytest.mark.parametrize("r_sp", [0.05, 0.2])
def test_sampling_and_residuals_exact(shape, r_sp):
    x = np.cumsum(np.random.default_rng(4).standard_normal(shape), axis=0).astype(np.float32)
    starts = p_est.block_starts(shape, r_sp)
    np.testing.assert_array_equal(starts, r_est.block_starts(shape, r_sp))
    assert p_est._split_strides(20, len(shape)) == r_est._split_strides(20, len(shape))
    for halo in (False, True):
        # the reference's functions run jitted, as its selector runs them
        gather = jax.jit(lambda v, halo=halo: r_est.gather_blocks(v, starts, halo=halo))
        want = np.asarray(gather(jnp.asarray(x)))
        np.testing.assert_array_equal(p_est.gather_blocks_np(x, starts, halo), want)
        np.testing.assert_array_equal(
            p_est.gather_blocks(torch.from_numpy(x), starts, halo).numpy(), want
        )
    delta = 1e-2 * float(x.max() - x.min())
    np.testing.assert_array_equal(
        p_est.lorenzo_residual_samples(torch.from_numpy(x), starts, delta).numpy(),
        np.asarray(jax.jit(lambda v: r_est.lorenzo_residual_samples(v, starts, delta))(
            jnp.asarray(x))),
    )


def _jitted(estimate, x):
    """(bitrate, psnr) of a reference estimator, run jitted as its selector
    runs it."""
    return jax.jit(lambda v: (lambda e: (e.bitrate, e.psnr))(estimate(v)))(jnp.asarray(x))


@pytest.mark.parametrize("mode", ["integer", "paper"])
def test_estimate_sz_matches_reference(mode):
    x = FIELDS["hur/QICE_0"]
    starts = r_est.block_starts(x.shape, 0.05)
    vr = float(x.max() - x.min())
    delta = 2e-3 * vr
    want = _jitted(lambda v: r_est.estimate_sz(v, delta, starts, vr, mode=mode), x)
    got = p_est.estimate_sz(torch.from_numpy(x), delta, starts, vr, mode=mode)
    assert float(got.bitrate) == pytest.approx(float(want[0]), abs=1e-4)
    assert float(got.psnr) == pytest.approx(float(want[1]), abs=1e-4)


@pytest.mark.parametrize("mode", ["exact", "paper"])
def test_estimate_zfp_matches_reference(mode):
    x = FIELDS["atm/ATM_05"]
    starts = r_est.block_starts(x.shape, 0.05)
    vr = float(x.max() - x.min())
    want = _jitted(lambda v: r_est.estimate_zfp(v, 1e-3 * vr, starts, vr, mode=mode), x)
    got = p_est.estimate_zfp(torch.from_numpy(x), 1e-3 * vr, starts, vr, mode=mode)
    assert float(got.bitrate) == pytest.approx(float(want[0]), abs=1e-4)
    assert float(got.psnr) == pytest.approx(float(want[1]), abs=1e-3)


def test_sz_closed_forms_match_reference():
    vr = 3.7
    for eb in (1e-5, 1e-3, 0.1):
        assert float(p_est.sz_psnr(eb, vr)) == pytest.approx(float(r_est.sz_psnr(eb, vr)), abs=1e-4)
    for psnr in (40.0, 61.23, 97.5):
        got = float(p_est.sz_delta_for_psnr(torch.tensor(psnr), vr))
        want = float(r_est.sz_delta_for_psnr(jnp.float32(psnr), vr))
        assert got == pytest.approx(want, rel=1e-6)
    hist = np.bincount(np.random.default_rng(5).geometric(0.05, 4000), minlength=300)
    got = float(p_est.sz_bitrate_from_hist(torch.from_numpy(hist), torch.tensor(0.01), 10**6, 300))
    want = float(r_est.sz_bitrate_from_hist(jnp.asarray(hist), jnp.float32(0.01), 10**6, 300))
    assert got == pytest.approx(want, abs=1e-5)
    assert p_est.PSNR_MATCH_QUANTUM == r_est.PSNR_MATCH_QUANTUM


def test_table_bits_probe_and_override(monkeypatch):
    assert p_est.TABLE_BITS_PER_SYMBOL == r_est.TABLE_BITS_PER_SYMBOL
    monkeypatch.setenv("REPRO_SZ_TABLE_BITS", "40")
    assert p_est._table_bits_per_symbol() == 40.0
    monkeypatch.delenv("REPRO_SZ_TABLE_BITS")
    assert p_est._table_bits_per_symbol() == r_est._table_bits_per_symbol()
