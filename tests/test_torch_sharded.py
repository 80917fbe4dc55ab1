"""The port's shard-local engine (`repro_torch.core.sharded`) against the
reference's (`repro.core.sharded`).

One 4-rank gloo job (`repro_torch.launch.mhrun`, the scenarios of
`tests/torch_shard_worker.py`) runs the port on a (2, 2) ('data', 'model')
mesh of DTensors; this process runs the reference on a (2, 2) mesh of the
first four emulated CPU devices, in device-id order (so device id and rank
name the same shard), over the same tree: the sizes and layouts of
`tests/test_sharded_compress.py::_mixed_tree`. The tests then hold:

* layout eligibility (`analyze`) and `fold_plan` to the reference's;
* `plan_tree` under stats, samples, fixed_psnr and fixed_ratio to the
  reference's, to the golden suite's tolerances (codec equal, eb_sz within
  a relative 1e-5, rates within 5e-3 bits a value), and the samples
  decisions to the port's own unsharded `select_many` / `solve_many`
  exactly;
* the segment geometry and every segment's bytes to the reference's
  `encode_plan` (host coder), and `decode_segments` bit for bit;
* block ownership (`_owned_starts`) to the reference's;
* `compress_pytree(sharded=True)` round trips on every rank;
* the float `psum`'s order (`dist.sum_in_rank_order`) to the reference's
  CPU `psum`.

The job runs under `mhrun`'s hard timeout, so it cannot hang the suite.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.core import Policy as RPolicy
from repro.core import sharded as r_shd
from repro_torch.core import select_many, solve_many
from repro_torch.core import sharded as p_shd
from repro_torch.runtime import dist

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

EB_SZ_RTOL = 1e-5
BR_ATOL = 5e-3


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sharded_job")
    payloads = W.run_job("sharded", 4, wd)
    segs = {}
    for r in range(4):
        with open(wd / f"segments.{r}.pkl", "rb") as f:
            for k, rows in pickle.load(f).items():
                segs.setdefault(k, []).extend(rows)
    return payloads, {k: sorted(v, key=lambda s: s[0]) for k, v in segs.items()}


@pytest.fixture(scope="module")
def mesh(emulated_devices):
    return Mesh(np.array(emulated_devices[:4]).reshape(2, 2), ("data", "model"))


def _rpolicy(spec):
    mode, target = spec
    if mode == "fixed_accuracy":
        return RPolicy.fixed_accuracy(eb_rel=target)
    return getattr(RPolicy, mode)(target)


@pytest.fixture(scope="module")
def ref(mesh):
    """The reference's decisions, segments and layouts on the same tree."""
    arrays = W.mixed_arrays()
    tree = {k: x if sp is None else jax.device_put(x, NamedSharding(mesh, P(*sp)))
            for k, (x, sp) in arrays.items()}
    plans = {}
    for label, pol, rec in W.MODES:
        got = r_shd.plan_tree([tree[k] for k in W.FLOATS], _rpolicy(pol), reconcile=rec)
        plans[label] = dict(zip(W.FLOATS, got))
    segs = {k: [(s.start, s.stop, s.codec, s.data)
                for s in r_shd.encode_plan(tree[k], plans["samples"][k])] for k in W.FLOATS}
    return tree, plans, segs


def _close(got, want, label, name):
    assert got["codec"] == want.codec, (label, name, got, want)
    assert got["eb_abs"] == want.eb_abs, (label, name)
    assert abs(got["eb_sz"] - want.eb_sz) <= EB_SZ_RTOL * abs(want.eb_sz), (label, name)
    for k in ("br_sz", "br_zfp"):
        assert abs(got[k] - getattr(want, k)) <= BR_ATOL, (label, name, k)


@pytest.mark.parametrize("shape", [
    (128, 96), (2, 3, 8, 32, 32), (3, 100), (1, 2, 64), (4, 8, 16, 16), (8,), (), (2, 2),
    (5, 6, 7, 8), (1, 1, 1, 64),
])
def test_fold_plan_matches_reference(shape):
    assert p_shd.fold_plan(shape) == r_shd.fold_plan(shape)


def test_layout_eligibility_matches_reference(port, mesh):
    payload = port[0][0]
    rng = np.random.default_rng(4)
    for (shape, sp), got in zip(W.ELIGIBILITY, payload["eligibility"]):
        x = jax.device_put(rng.standard_normal(shape).astype(np.float32), NamedSharding(mesh, P(*sp)))
        lay = r_shd.analyze(x)
        assert (got is None) == (lay is None), (shape, sp, got)
        if lay is None:
            continue
        assert tuple(got["view_shape"]) == lay.view_shape, (shape, sp)
        assert tuple(got["local_view"]) == lay.local_view, (shape, sp)
        assert tuple(got["axis_of_dim"]) == lay.axis_of_dim, (shape, sp)
        want = [[list(s.start), list(s.stop), [d.id for d in s.devices]] for s in lay.segs]
        assert got["segs"] == want, (shape, sp)
    assert payload["host_array_layout"]
    assert r_shd.analyze(np.zeros((64, 64), np.float32)) is None


def test_every_rank_holds_the_same_decisions(port):
    payloads, _ = port
    for p in payloads[1:]:
        assert p["plans"] == payloads[0]["plans"]
        assert p["backend"] == "gloo"


@pytest.mark.parametrize("label", [m[0] for m in W.MODES])
def test_plan_tree_matches_reference(port, ref, label):
    got = port[0][0]["plans"][label]
    want = ref[1][label]
    for name in W.FLOATS:
        _close(got[name], want[name].selection, label, name)
        # a gathered field is named so on both sides
        assert (got[name]["path"] == "gather") == (not want[name].sharded), name
        assert got[name]["reconcile"] == want[name].reconcile, (label, name)
    assert got["uneven"]["path"] == "gather" and got["uneven"]["reconcile"] == "host"
    assert got["vol"]["path"] == "shard-local"


@pytest.mark.parametrize("label", [m[0] for m in W.MODES if m[2] != "stats"])
def test_samples_decisions_equal_unsharded(port, label):
    """The samples reconciliation feeds the deciders the blocks the whole
    field gives, in the unsharded batch composition: decisions equal the
    port's own unsharded ones exactly."""
    got = port[0][0]["plans"][label]
    pol = W.policy(next(m[1] for m in W.MODES if m[0] == label))
    fields = [W.mixed_arrays()[k][0] for k in W.FLOATS]
    if pol.mode == "fixed_accuracy":
        want = select_many(fields, policy=pol, device="cpu")
    else:
        want = [s.selection for s in solve_many(fields, pol, device="cpu")]
    for name, w in zip(W.FLOATS, want):
        rec = {k: v for k, v in got[name].items() if k not in ("reconcile", "path")}
        assert rec == {k: getattr(w, k) for k in rec}, (label, name)


def test_segments_match_reference_bytes(port, ref):
    _, segs = port
    _, plans, rsegs = ref
    for name in W.FLOATS:
        got, want = segs[name], rsegs[name]
        assert [(tuple(s[0]), tuple(s[1]), s[2]) for s in got] == \
            [(tuple(s[0]), tuple(s[1]), s[2]) for s in want], name
        for g, w in zip(got, want):
            assert g[3] == w[3], (name, g[0])
    assert len(segs["both"]) == 4 and len(segs["dp"]) == 2 and len(segs["uneven"]) == 1


def test_decode_segments_bit_for_bit(port, ref):
    _, segs = port
    _, plans, rsegs = ref
    for name in W.FLOATS:
        view = plans["samples"][name].view_shape
        got = p_shd.decode_segments(view, [p_shd.Segment(*s) for s in segs[name]])
        want = r_shd.decode_segments(view, [r_shd.Segment(*s) for s in rsegs[name]])
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_block_ownership_matches_reference(port, ref):
    from repro.core import estimator as r_est

    tree = ref[0]
    for name, got in port[0][0]["owned"].items():
        lay = r_shd.analyze(tree[name])
        starts = r_est.block_starts(lay.view_shape, 0.05)
        want = r_shd._owned_starts(lay, starts)
        assert sorted(got) == sorted(str(d.id) for d in want), name
        for dev, (lst, slots) in want.items():
            assert got[str(dev.id)][0] == [list(t) for t in lst], (name, dev.id)
            assert got[str(dev.id)][1] == list(slots), (name, dev.id)


def test_decision_cache_replays_engine_fields(port):
    """Engine fields fingerprint on the merged moments: an identical second
    `plan_tree` replays them ('cached'); gathered and degenerate fields
    re-decide; every decision equals the cold one."""
    for p in port[0]:
        warm = dict(zip(W.FLOATS, p["warm"]["reconcile"]))
        assert all(p["warm"]["equal"])
        assert warm["uneven"] == "host" and warm["const"] == "degenerate"
        assert {warm[k] for k in ("both", "dp", "tp", "vol", "repl", "rough", "conv")} == {"cached"}
        assert p["warm"]["events"]["dp"] == "hit"


def test_compress_pytree_sharded_round_trips(port):
    arrays = W.mixed_arrays()
    for p in port[0]:
        rt = p["roundtrip"]
        for name, (x, spec) in arrays.items():
            r = rt[name]
            assert r["shape"] == list(x.shape) and r["dtype"] == str(x.dtype), name
            if name in W.FLOATS and r["codec"] in ("sz", "zfp"):
                assert r["kind"] == "ShardedCompressedField", name
                assert r["max_err"] <= r["eb"], name
            else:
                assert r["exact"], name
        assert rt["both"]["segments"] == 4 and rt["uneven"]["segments"] == 1


def test_float_psum_adds_in_the_reference_order(mesh):
    """The reference's CPU `psum` over 4 devices adds the partials one
    device after another; `dist.sum_in_rank_order` takes that order (the
    other orders disagree on these values)."""
    shard_map = getattr(jax, "shard_map", None)
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(64):
        v = (rng.standard_normal(4) * 10.0 ** rng.integers(-8, 8, 4)).astype(np.float32)
        x = jax.device_put(v.reshape(2, 2, 1), NamedSharding(mesh, P("data", "model")))
        kw = dict(mesh=mesh, in_specs=P("data", "model"), out_specs=P())
        if shard_map is None:
            from jax.experimental.shard_map import shard_map as _sm
            f = _sm(lambda a: jax.lax.psum(a, ("data", "model")), check_rep=False, **kw)
        else:
            f = shard_map(lambda a: jax.lax.psum(a, ("data", "model")), check_vma=False, **kw)
        want = np.asarray(jax.jit(f)(x)).reshape(-1)[0]
        got = dist.sum_in_rank_order(torch.from_numpy(v)).item()
        assert np.float32(got) == want
        pair = (v[0] + v[1]) + (v[2] + v[3])
        hits += int(pair != want)
    assert hits > 0  # the values tell the orders apart
