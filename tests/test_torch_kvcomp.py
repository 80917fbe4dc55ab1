"""The port's KV page tier (`repro_torch.runtime.kvcomp`) and what it needs
(`estimate_zfp_many`, `DecisionCache`, the serving policies) against the
reference, on the CPU, with numpy-seeded pages.

Tolerances, each with its reason:

* `estimate_zfp_many` rates: within 1e-6 bits/value (integer bit totals
  over the same blocks). PSNR within 1e-3 dB (float32 prefix sums in
  another order) for fields whose plane steps 2^p the reference computes
  exactly; its compiled float32 `exp2` is exact only for p in [-12, 12],
  and beyond that its step is off by ~5e-7 relative, which moves the
  truncation of knife-edge sample points: there within 0.05 dB.
* The solved bound `eb`: float32 bit for bit. Bits per block: equal.
* `compress_page`: codec, nbytes, eb and fingerprint digest equal; raw
  and device-encoded payload bytes equal; a 'bot' payload within eb of the
  reference's (both are within eb of the page) and within the stated
  float32 / bfloat16 rounding of the page itself.
* `DecisionCache` events: the reference's, event for event.
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Policy as RPolicy
from repro.core import estimator as r_est
from repro.core import policy as r_policy
from repro.core.decision_cache import DecisionCache as RCache
from repro.runtime import kvcomp as rk
from repro_torch.core import Policy
from repro_torch.core import estimator as p_est
from repro_torch.core import interop
from repro_torch.core import policy as p_policy
from repro_torch.core.controller import TargetSolution
from repro_torch.core.decision_cache import DecisionCache
from repro_torch.core.selector import Selection
from repro_torch.core.transforms import bot_linf_gain
from repro_torch.runtime import kvcomp as pk

NAME = "kv/long/0/k0"


def _page(shape, seed, kind="walk"):
    """A KV-like page: a random walk along tokens (axis -2) with lognormal
    per-channel scales; 'smooth' integrates twice; 'noise' is uniform."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    x = np.cumsum(rng.standard_normal(shape), axis=-2)
    if kind == "smooth":
        x = np.cumsum(x, axis=-1) / shape[-1]
    return (x * np.exp(rng.standard_normal(shape[-1]))).astype(np.float32)


def _as_dtype(x, dtype):
    """The same page on both sides: the reference's numpy array (bfloat16
    through ml_dtypes) and the port's tensor built from its exact bytes."""
    ref = np.asarray(jnp.asarray(x).astype(dtype))
    port = torch.frombuffer(bytearray(ref.tobytes()), dtype=getattr(torch, dtype))
    return ref, port.reshape(ref.shape)


def _vr(x):
    return jnp.maximum(jnp.max(x) - jnp.min(x), 1e-12), torch.clamp_min(
        torch.from_numpy(np.asarray(x)).max() - torch.from_numpy(np.asarray(x)).min(), 1e-12
    )


def _bits32(v) -> int:
    return int(np.asarray(v, np.float32).view(np.int32))


# -- estimator --------------------------------------------------------------


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("mode", ["exact", "model"])
def test_estimate_zfp_many_matches_reference(nd, mode):
    shapes = [(96, 128), (64, 64), (40, 72)] if nd == 2 else [(8, 32, 64), (12, 16, 48), (4, 16, 256)]
    blocks, seg, bounds, ebs, vrs = [], [], [0], [], []
    for f, shape in enumerate(shapes):
        x = _page(shape, 10 + f, ["walk", "smooth", "noise"][f]) * 10.0**f
        starts = r_est.block_starts(shape, r_est.DEFAULT_SAMPLING_RATE)
        b = r_est.gather_blocks_np(x, starts)
        blocks.append(b)
        seg += [f] * len(b)
        bounds.append(bounds[-1] + len(b))
        vr = float(x.max() - x.min())
        vrs.append(vr)
        ebs.append(vr * 2.0 ** -(6 + 3 * f))
    blocks = np.concatenate(blocks).astype(np.float32)
    args = (np.asarray(seg, np.int32), np.asarray(bounds, np.int32),
            np.asarray(ebs, np.float32), np.asarray(vrs, np.float32))
    # jitted, as the reference's batched engine runs it
    r = r_est.Estimate(*jax.jit(lambda *a: dataclasses.astuple(
        r_est.estimate_zfp_many(*a, mode=mode)))(jnp.asarray(blocks), *map(jnp.asarray, args)))
    p = p_est.estimate_zfp_many(torch.from_numpy(blocks), *map(torch.from_numpy, args), mode=mode)
    np.testing.assert_allclose(p.bitrate.numpy(), np.asarray(r.bitrate), rtol=0, atol=1e-6)
    # plane exponents p of every block, and whether the reference's exp2 is exact there
    mx = np.maximum(np.abs(blocks).reshape(len(blocks), -1).max(axis=1), np.float32(1e-30))
    e = np.ceil(np.log2(mx.astype(np.float64)))
    gain = bot_linf_gain("zfp") ** nd
    pexp = np.floor(np.log2(np.asarray(ebs)[seg] / (np.exp2(e) * gain)))
    exact = np.asarray(jnp.exp2(jnp.asarray(pexp, jnp.float32))) == np.exp2(pexp)
    field_exact = np.asarray([exact[bounds[f]:bounds[f + 1]].all() for f in range(len(shapes))])
    assert field_exact.any()
    tol = np.where(field_exact, 1e-3, 0.05)
    assert np.all(np.abs(p.psnr.numpy() - np.asarray(r.psnr)) <= tol)


def test_field_sums_int32_and_float():
    rng = np.random.default_rng(0)
    bounds = np.asarray([0, 3, 3, 10, 17], np.int32)
    ints = rng.integers(0, 2**20, size=17).astype(np.int32)
    got = p_est.field_sums(torch.from_numpy(ints), torch.from_numpy(bounds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_est.field_sums(jnp.asarray(ints), jnp.asarray(bounds))))
    cols = rng.standard_normal((17, 2)).astype(np.float32)
    np.testing.assert_allclose(
        p_est.field_sums(torch.from_numpy(cols), torch.from_numpy(bounds)).numpy(),
        np.asarray(r_est.field_sums(jnp.asarray(cols), jnp.asarray(bounds))), rtol=1e-6, atol=1e-6)


# -- the ratio grid and bot_compress_kv ---------------------------------------


@pytest.mark.parametrize("shape,kind", [((4, 16, 64), "walk"), ((2, 8, 64), "smooth"),
                                        ((256, 256), "walk"), ((128, 96), "noise")])
@pytest.mark.parametrize("ratio", [4.0, 8.0, 16.0, 64.0])
def test_budget_eb_and_bits_match_reference(shape, kind, ratio):
    """The solved bound is float32-bitwise the reference's and the kernel
    bits equal; 64x is out of reach of these pages (the loosest candidate,
    vr/2, is the fallback on both sides)."""
    x = _page(shape, 20, kind)
    r_vr, p_vr = _vr(x)
    r_eb = rk._budget_eb(jnp.asarray(x), r_vr, ratio)
    p_eb = pk._budget_eb(torch.from_numpy(x), p_vr, ratio)
    assert p_eb.dtype == torch.float32 and p_eb.ndim == 0
    assert _bits32(p_eb) == _bits32(r_eb)
    r_recon, r_bits = rk.bot_compress_kv(jnp.asarray(x), RPolicy.fixed_ratio(ratio))
    p_recon, p_bits = pk.bot_compress_kv(torch.from_numpy(x), Policy.fixed_ratio(ratio))
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    eb = float(p_eb)
    assert float(np.abs(p_recon.numpy().astype(np.float64) - x).max()) <= eb
    if ratio == 64.0:
        assert eb == float(np.float32(float(r_vr) / 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bot_compress_kv_default_and_legacy_kwargs(dtype):
    x = _page((64, 128), 21)
    ra, pa = _as_dtype(x, dtype)
    r_recon, r_bits = rk.bot_compress_kv(jnp.asarray(ra))
    p_recon, p_bits = pk.bot_compress_kv(pa)
    assert p_recon.dtype == pa.dtype
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(r_bits))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = pk.bot_compress_kv(pa, eb_rel=1e-2)
    assert torch.equal(legacy[1], p_bits)  # eb_rel 1e-2 is the default policy
    with pytest.warns(DeprecationWarning):
        by_ratio = pk.bot_compress_kv(pa, target_ratio=8.0)
    assert torch.equal(by_ratio[1], pk.bot_compress_kv(pa, Policy.fixed_ratio(8.0))[1])
    with pytest.warns(DeprecationWarning):
        positional = pk.bot_compress_kv(pa, 1e-2)
    assert torch.equal(positional[1], p_bits)
    with pytest.raises(ValueError):
        pk.bot_compress_kv(pa, Policy.fixed_ratio(8.0), eb_rel=1e-2)
    with pytest.raises(ValueError):
        pk.bot_compress_kv(pa, Policy.fixed_psnr(60.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pk.bot_compress_kv(pa, Policy.fixed_accuracy(eb_abs=0.5))  # no warning


def test_quantize_kv_matches_reference():
    x = np.random.default_rng(0).standard_normal((4, 16, 8, 32)).astype(np.float32)
    rq, rs = rk.quantize_kv(jnp.asarray(x))
    pq, ps = pk.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    back = pk.dequantize_kv(pq, ps, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(rk.dequantize_kv(rq, rs, jnp.float32)))
    assert pk.dequantize_kv(pq, ps).dtype == torch.bfloat16


# -- compress_page / decompress_page -------------------------------------------

PAGE_CASES = [((2, 8, 64), "walk"), ((4, 16, 64), "walk"), ((256, 256), "smooth")]
MODES = {
    "fixed_ratio": (RPolicy.fixed_ratio(8.0), Policy.fixed_ratio(8.0), False),
    "fixed_accuracy": (RPolicy.fixed_accuracy(eb_rel=1e-2), Policy.fixed_accuracy(eb_rel=1e-2), False),
    "raw": (RPolicy.raw(), Policy.raw(), False),
    "device_encode": (RPolicy.fixed_ratio(8.0), Policy.fixed_ratio(8.0), True),
}


@pytest.mark.parametrize("shape,kind", PAGE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_compress_page_matches_reference(shape, kind, dtype, mode):
    r_pol, p_pol, device_encode = MODES[mode]
    ra, pa = _as_dtype(_page(shape, 30, kind), dtype)
    rcache, pcache = RCache(), DecisionCache()
    r = rk.compress_page(ra, r_pol, cache=rcache, name=NAME, device_encode=device_encode)
    p = pk.compress_page(pa, p_pol, cache=pcache, name=NAME, device_encode=device_encode,
                         device="cpu")
    assert (p.codec, p.shape, p.dtype, p.nbytes, p.clean) == (
        r.codec, tuple(r.shape), r.dtype, r.nbytes, r.clean)
    assert _bits32(p.eb) == _bits32(r.eb)
    assert pcache.events == rcache.events
    if r.codec != "raw":
        re, pe = rcache.entries[NAME], pcache.entries[NAME]
        assert pe.fingerprint == re.fingerprint  # blake2b digests equal
        assert pe.selection == re.selection and pe.policy == re.policy
    back = pk.decompress_page(p, device="cpu")
    r_back = rk.decompress_page(r)
    assert back.dtype == pa.dtype and tuple(back.shape) == shape
    page = pa.to(torch.float32)
    if r.codec in ("raw", "zfp"):
        assert p.payload == r.payload
        np.testing.assert_array_equal(back.to(torch.float32).numpy(),
                                      np.asarray(r_back).astype(np.float32))
    else:
        diff = np.abs(p.payload.to(torch.float32).numpy() - np.asarray(r.payload).astype(np.float32))
        assert float(diff.max()) <= p.eb
    if r.codec == "raw":
        assert torch.equal(back, pa)
    else:
        rel = 2.0**-8 if dtype == "bfloat16" else 0.0
        err = (back.to(torch.float32) - page).abs()
        assert bool((err <= p.eb + rel * back.to(torch.float32).abs()).all())


def test_device_encode_page_is_zfp_bytes():
    """A smooth page the device encoder packs: the reference's ZFJX bytes."""
    ra, pa = _as_dtype(_page((256, 256), 31, "smooth"), "float32")
    r = rk.compress_page(ra, RPolicy.fixed_ratio(8.0), device_encode=True)
    p = pk.compress_page(pa, Policy.fixed_ratio(8.0), device_encode=True, device="cpu")
    assert r.codec == p.codec == "zfp" and p.payload == r.payload


@pytest.mark.parametrize("shape", [(4, 16, 64), (256, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_fingerprint_digests_match(shape, dtype):
    ra, pa = _as_dtype(_page(shape, 32), dtype)
    for r_pol, p_pol in ((RPolicy.fixed_ratio(8.0), Policy.fixed_ratio(8.0)),
                         (RPolicy.fixed_accuracy(eb_rel=1e-2), Policy.fixed_accuracy(eb_rel=1e-2))):
        vr = float(np.float32(1.2345))
        assert pk._page_fingerprint(pa, vr, p_pol) == rk._page_fingerprint(ra, vr, r_pol)


def test_decision_cache_events_match_reference():
    """Miss, then hit on a re-evicted frozen page, then invalidated after a
    perturbation, with the same bounds, on both sides."""
    x = _page((2, 8, 64), 5)
    rcache, pcache = RCache(), DecisionCache()
    pol = (RPolicy.fixed_ratio(8.0), Policy.fixed_ratio(8.0))
    trail = []
    for page in (x, x, x * 2.0):
        r = rk.compress_page(page, pol[0], cache=rcache, name=NAME)
        p = pk.compress_page(torch.from_numpy(page), pol[1], cache=pcache, name=NAME, device="cpu")
        assert (p.eb, p.nbytes) == (r.eb, r.nbytes)
        assert pcache.events[NAME] == rcache.events[NAME]
        trail.append(pcache.events[NAME])
    assert trail == ["miss", "hit", "invalidated"]
    assert pcache.stats() == rcache.stats()
    with pytest.raises(ValueError):
        pk.compress_page(torch.from_numpy(x), pol[1], cache=pcache, device="cpu")  # no name


def test_reference_manifest_replays_in_the_port():
    """A bound the reference solved, carried over as plain JSON, replays
    as a cache hit in the port with the same bound and bytes."""
    x = _page((4, 16, 64), 6)
    rcache = RCache()
    r = rk.compress_page(x, RPolicy.fixed_ratio(8.0), cache=rcache, name=NAME)
    record = json.loads(json.dumps(rcache.to_manifest()))
    pcache = interop.decision_cache_from_manifest(record)
    assert pcache.to_manifest() == record
    p = pk.compress_page(torch.from_numpy(x), Policy.fixed_ratio(8.0), cache=pcache,
                         name=NAME, device="cpu")
    assert pcache.events[NAME] == "hit"
    assert (p.eb, p.nbytes, p.codec) == (r.eb, r.nbytes, r.codec)


def test_cache_entry_round_trips_a_target_solution():
    cache = DecisionCache()
    sel = Selection("zfp", 0.5, 0.0, 0.0, 3.0, 0.0, 10.0, 0.05)
    sol = TargetSolution(sel, "fixed_ratio", 8.0, 61.5, 4.0, True)
    cache.store(NAME, (4, 16, 64), "float32", Policy.fixed_ratio(8.0), "kv_page",
                {"kind": "kv_page", "digest": "x"}, sel, solution=sol)
    e = cache.stale(NAME, (4, 16, 64), "float32", Policy.fixed_ratio(8.0), "kv_page")
    assert e.to_solution() == sol and sol.est_ratio == 8.0
    assert cache.stale(NAME, (4, 16, 64), "bfloat16", Policy.fixed_ratio(8.0), "kv_page") is None


def test_serving_policies_match_reference():
    for ratio in (4.0, 8.0):
        r, p = r_policy.serving_policies(ratio), p_policy.serving_policies(ratio)
        for name in ("kv/long/0", "kv/short/3", "other"):
            assert p.resolve(name).spec() == r.resolve(name).spec()
    pol = Policy.fixed_ratio(8.0)
    assert p_policy.as_policy_set(pol).resolve("x") == pol
    ps = p_policy.serving_policies()
    assert p_policy.as_policy_set(ps) is ps
    with pytest.raises(TypeError):
        p_policy.as_policy_set(8.0)
