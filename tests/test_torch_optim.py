"""The port's optimizer layer (`repro_torch.optim`) against the live
reference (`repro.optim`) on the CPU.

* Gradient compression: dequantized gradients and residuals bit for bit
  against `jax.jit(repro.optim.compress.compress)` over chained steps;
  `wire_bits_per_value` to a relative 1e-6 (the entropy's float32 sum runs
  in another order). Past 2^24 codes in one bin the reference's float32
  histogram stops counting; the port's integer counts do not.
* AdamW: the schedule within 2 ulp (bit for bit on these grids). While the
  global norm is at most `clip_norm` (so the clip scale is exactly 1), m
  and v are bit for bit and params within one ulp of max|p| (the
  reference fuses ``p - lr * delta`` into one rounding, the port rounds
  ``lr * delta`` first). Where the clip bites, the scale carries the
  global norm's float32 sum, which XLA takes in another order: then m, v
  and params are held to a relative 1e-6 of each leaf's max|value|, and
  `grad_norm` to a relative 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Policy as RPolicy
from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro_torch import optim as poptim
from repro_torch.core import Policy
from repro_torch.core import pytree
from repro_torch.optim import adamw as padamw
from repro_torch.optim import compress as pcompress


def _leaves(tree):
    return [np.asarray(leaf) for _, leaf in pytree.flatten_with_path(tree)[0]]


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _grad_tree(rng, scale_of):
    """Leaves of several shapes and scales (1e-6 to 10), one constant."""
    shapes = {"a": (64, 33), "b": {"w": (3, 17, 40), "n": (7,)}, "c": (1000,),
              "d": {"e": (5, 13)}, "const": (4, 6)}
    scales = {"a": 1e-6, "b/w": 10.0, "b/n": 1e-3, "c": 0.1, "d/e": 1.0, "const": 0.0}

    def leaf(name, shape):
        if name == "const":
            return np.full(shape, 0.375 * scale_of, np.float32)
        return (rng.standard_normal(shape) * scales[name] * scale_of).astype(np.float32)

    return {k: ({kk: leaf(f"{k}/{kk}", s) for kk, s in v.items()} if isinstance(v, dict)
                else leaf(k, v)) for k, v in shapes.items()}


@pytest.mark.parametrize("eb_rel,hist_bits", [(1e-3, 8), (1e-4, 8), (1e-2, 4)])
def test_compress_equals_reference_over_chained_steps(eb_rel, hist_bits):
    rng = np.random.default_rng(int(eb_rel * 1e5) + hist_bits)
    rcfg = rcompress.GradCompressConfig(eb_rel=eb_rel, hist_bits=hist_bits)
    pcfg = pcompress.GradCompressConfig(eb_rel=eb_rel, hist_bits=hist_bits)
    rfn = jax.jit(lambda g, s: rcompress.compress(rcfg, g, s))
    g0 = _grad_tree(rng, 1.0)
    rstate, pstate = rcompress.init(g0), pcompress.init(_to_torch(g0))
    for step in range(3):
        g = jax.tree_util.tree_map(lambda a: (a * (1 + step) + (a.std() + 1e-7) * 0.1 * rng.standard_normal(a.shape)).astype(np.float32), g0)  # noqa: E501
        rgq, rstate, rm = rfn(g, rstate)
        pgq, pstate, pm = pcompress.compress(pcfg, _to_torch(g), pstate)
        for got, want in zip(_leaves(pgq), _leaves(rgq)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(_leaves(pstate["residual"]), _leaves(rstate["residual"])):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(float(pm["wire_bits_per_value"]),
                                   float(rm["wire_bits_per_value"]), rtol=1e-6)


def test_residual_in_slices_equals_reference(monkeypatch):
    """The residual's float64 multiply-add taken in slices of 7 values
    (every leaf in several, most with a ragged last slice) is the
    compiled reference's fused residual bit for bit."""
    monkeypatch.setattr(pcompress, "_FMA_CHUNK", 7)
    g = _grad_tree(np.random.default_rng(3), 1.0)
    r = jax.tree_util.tree_map(lambda a: (a * 1e-3).astype(np.float32), g)
    rfn = jax.jit(lambda g, s: rcompress.compress(rcompress.GradCompressConfig(), g, s))
    rgq, rstate, _ = rfn(g, {"residual": r})
    pgq, pstate, _ = pcompress.compress(pcompress.GradCompressConfig(), _to_torch(g),
                                        {"residual": _to_torch(r)})
    for got, want in zip(_leaves(pgq) + _leaves(pstate), _leaves(rgq) + _leaves(rstate)):
        np.testing.assert_array_equal(got, want)


def test_compress_config_policy_spelling():
    assert pcompress.GradCompressConfig.from_policy(Policy.fixed_accuracy(eb_rel=1e-4)).eb_rel == 1e-4
    assert (pcompress.GradCompressConfig(policy=Policy.fixed_accuracy(eb_rel=2e-3)).eb_rel
            == rcompress.GradCompressConfig(policy=RPolicy.fixed_accuracy(eb_rel=2e-3)).eb_rel)
    for pol, rpol in [(Policy.fixed_ratio(8.0), RPolicy.fixed_ratio(8.0)),
                      (Policy.fixed_psnr(60.0), RPolicy.fixed_psnr(60.0)),
                      (Policy.fixed_accuracy(eb_abs=1e-3), RPolicy.fixed_accuracy(eb_abs=1e-3))]:
        with pytest.raises(ValueError) as want:
            rcompress.GradCompressConfig(policy=rpol)
        with pytest.raises(ValueError, match="value-range-relative") as got:
            pcompress.GradCompressConfig(policy=pol)
        assert str(got.value) == str(want.value)


def test_compress_init_and_tree_mismatch():
    tree = {"b": torch.ones(3, 2), "a": [torch.ones(4), torch.ones(())]}
    state = pcompress.init(tree)
    assert [(n, r.shape, r.dtype) for n, r in
            [(pytree.leaf_name(p), r) for p, r in pytree.flatten_with_path(state["residual"])[0]]] == [
        ("a/0", (4,), torch.float32), ("a/1", (), torch.float32), ("b", (3, 2), torch.float32)]
    assert all(not r.any() for r in _leaves(state["residual"]))
    with pytest.raises(ValueError, match="residual tree"):
        pcompress.compress(pcompress.GradCompressConfig(), tree, {"residual": {"b": tree["b"]}})


def _entropy(counts) -> float:
    p = np.asarray(counts, np.float64)
    p = p[p > 0] / p.sum()
    return float(-(p * np.log2(p)).sum())


def test_histogram_counts_past_2p24():
    """A leaf whose zero bin holds 2^24 + 2^22 codes and whose top bin holds
    2^22: the reference's float32 histogram reads the zero bin as 2^24 (its
    wire bits are the entropy of the capped counts), the port's integer
    counts do not (its wire bits are the exact entropy)."""
    n0, n1 = 2**24 + 2**22, 2**22
    g = np.zeros(n0 + n1, np.float32)
    g[::6] = 1.0  # every sixth value: n1 of them
    assert int((g != 0).sum()) == n1
    cfg = dict(eb_rel=1e-3)
    rbits = float(jax.jit(lambda a: rcompress.compress(
        rcompress.GradCompressConfig(**cfg), {"g": a}, rcompress.init({"g": a}))[2]
        ["wire_bits_per_value"])(jnp.asarray(g)))
    gt = torch.from_numpy(g)
    _, _, pm = pcompress.compress(pcompress.GradCompressConfig(**cfg), {"g": gt},
                                  pcompress.init({"g": gt}))
    capped, exact = _entropy([2**24, n1]) + 0.5, _entropy([n0, n1]) + 0.5
    assert abs(capped - exact) > 0.05
    np.testing.assert_allclose(rbits, capped, rtol=1e-6)
    np.testing.assert_allclose(float(pm["wire_bits_per_value"]), exact, rtol=1e-6)


SCHEDULES = [dict(lr=1e-3, total_steps=100, warmup_steps=5),
             dict(lr=3e-4, total_steps=25, warmup_steps=5),
             dict(lr=3e-4, total_steps=20, warmup_steps=0, min_lr_frac=0.3),
             dict(lr=1e-2, total_steps=7, warmup_steps=7)]


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("si", range(len(SCHEDULES)))
def test_schedule_within_two_ulp(si):
    rcfg, pcfg = radamw.AdamWConfig(**SCHEDULES[si]), padamw.AdamWConfig(**SCHEDULES[si])
    rfn = jax.jit(lambda s: radamw.schedule(rcfg, s))
    for s in range(rcfg.total_steps + 6):
        want = np.asarray(rfn(jnp.float32(s)))
        got = padamw.schedule(pcfg, torch.tensor(float(s))).numpy()
        assert got.dtype == np.float32 and _ulps(got, want) <= 2, (s, got, want)


def _param_tree(rng):
    return {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": {"w": (0.1 * rng.standard_normal((3, 17, 40))).astype(np.float32),
                  "n": np.ones(40, np.float32), "odd": rng.standard_normal((7, 13)).astype(np.float32)}}


def _close_to_max(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_equals_reference_over_chained_steps(clipped):
    rng = np.random.default_rng(7 + clipped)
    kw = dict(lr=1e-3, total_steps=20, warmup_steps=2)
    rcfg, pcfg = radamw.AdamWConfig(**kw), padamw.AdamWConfig(**kw)
    rfn = jax.jit(lambda g, s, p: radamw.update(rcfg, g, s, p))
    params = _param_tree(rng)
    rp, rs = params, radamw.init(params)
    pp = _to_torch(params)
    ps = padamw.init(pp)
    assert ps["step"].dtype == torch.int32 and ps["step"].ndim == 0
    for step in range(5):
        # the global norm stays below clip_norm = 1 unless `clipped`
        scale = 3.0 if clipped else 1e-3
        g = jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), params)
        rp, rs, rm = rfn(g, rs, rp)
        pp, ps, pm = padamw.update(pcfg, _to_torch(g), ps, pp)
        assert (float(rm["grad_norm"]) > 1.0) == clipped
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        assert _ulps(float(pm["lr"]), float(rm["lr"])) <= 2
        assert int(ps["step"]) == int(rs["step"]) == step + 1
        for key in ("m", "v"):
            for got, want in zip(_leaves(ps[key]), _leaves(rs[key])):
                if clipped:
                    _close_to_max(got, want, 1e-6)
                else:
                    np.testing.assert_array_equal(got, want)
        for got, want in zip(_leaves(pp), _leaves(rp)):
            _close_to_max(got, want, 1e-6 if clipped else 2.0**-23)


def test_adamw_updates_in_place():
    p = {"w": torch.randn(4, 5, generator=torch.Generator().manual_seed(0))}
    w, state = p["w"], padamw.init(p)
    m = state["m"]["w"]
    before = w.clone()
    new_p, new_state, _ = padamw.update(padamw.AdamWConfig(), {"w": torch.ones(4, 5)}, state, p)
    assert new_p["w"] is w and new_state["m"]["w"] is m and not torch.equal(w, before)
    assert float(padamw.global_norm({"a": torch.full((4,), 3.0), "b": [torch.full((4,), 4.0)]})) \
        == float(radamw.global_norm({"a": jnp.full((4,), 3.0), "b": [jnp.full((4,), 4.0)]})) == 10.0


def test_optim_exports_match_reference():
    import repro.optim as roptim

    names = {n for n in dir(roptim) if not n.startswith("_")}
    assert names <= set(dir(poptim))
    assert poptim.AdamWConfig is padamw.AdamWConfig
    assert poptim.GradCompressConfig is pcompress.GradCompressConfig
    for cls_p, cls_r in ((padamw.AdamWConfig, radamw.AdamWConfig),
                         (pcompress.GradCompressConfig, rcompress.GradCompressConfig)):
        assert [f.name for f in padamw.dataclasses.fields(cls_p)] == \
            [f.name for f in padamw.dataclasses.fields(cls_r)]
