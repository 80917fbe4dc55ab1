"""The single-host `CheckpointManager` against `repro.checkpoint` on CPU JAX.

With `workers=0` and the host coder, a port save and a reference save of
the same tree and policy write the same `data.bin`, byte for byte, and
equal manifest field tables; each package restores the other's steps,
its decision cache included, so the next save is all hits. The
reference's contracts hold in the port: `async_save` surfaces encoder
errors from `wait()` and snapshots the tree when called, the bounded
`BarrierTimeout` requeue (`tests/test_checkpoint_async.py`, with the
port's `runtime.dist.barrier` replaced), keep-N pruning with the GC of
torn `.tmp_step_*` directories, and the legacy keyword shim's warning.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as RConfig
from repro.checkpoint import CheckpointManager as RManager
from repro.core.policy import Policy as RPolicy
from repro.core.policy import PolicySet as RPolicySet
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.core import selector as p_sel
from repro_torch.core.decision_cache import DecisionCache
from repro_torch.core.policy import Policy, PolicySet
from repro_torch.runtime import dist

CPU = dict(device="cpu")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.standard_normal((96, 96)), axis=0).astype(np.float32)
    nan = walk[:32, :40].copy()
    nan[5, 7] = np.nan
    return {
        "w": walk,
        "vol": np.cumsum(rng.standard_normal((8, 24, 24)), axis=2).astype(np.float32),
        "b": rng.standard_normal((96,)).astype(np.float32),
        "f64": np.cumsum(rng.standard_normal((40, 40)), axis=1),
        "bf16": rng.standard_normal((16, 32)).astype(np.float32),
        "ids": rng.integers(0, 1000, (64,)).astype(np.int32),
        "mask": rng.integers(0, 2, (8, 8)).astype(bool),
        "const": np.full((16, 16), 2.5, np.float32),
        "nan": nan,
        "opt": {"m": rng.standard_normal((64, 64)).astype(np.float32)},
        "step": np.array(7, np.int64),
        "lr": 3e-4,
    }


def _trees(seed=0):
    """The same tree for each package: the bfloat16 leaf as an `ml_dtypes`
    array for the reference and a tensor for the port (the same bits)."""
    a = _arrays(seed)
    ref = dict(a, bf16=a["bf16"].astype(ml_dtypes.bfloat16))
    port = dict(a, bf16=torch.from_numpy(a["bf16"]).to(torch.bfloat16))
    return port, ref


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def _data(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "data.bin"), "rb") as f:
        return f.read()


def _untimed(man):
    """A manifest without its times and its decision cache (held apart by
    `_same_cache`)."""
    return {
        k: v for k, v in man.items()
        if k not in ("wall_time", "save_seconds", "decision_cache")
    }


def _same_cache(a: dict, b: dict):
    """Two manifests' cache records hold the same entries: keys, digests and
    codecs equal, bounds equal, the float32 moments to a relative 1e-4
    (`tests/test_torch_predictor.py`) and the estimates to the golden
    tolerances."""
    ea = {e["name"]: e for e in a["entries"]}
    eb = {e["name"]: e for e in b["entries"]}
    assert set(ea) == set(eb) and a["tolerance"] == b["tolerance"]
    for n, x in ea.items():
        y = eb[n]
        for k in ("shape", "dtype", "policy", "transform", "solution", "step"):
            assert x[k] == y[k], (n, k)
        fx, fy = x["fingerprint"], y["fingerprint"]
        for k in ("kind", "digest", "vr", "size", "n", "smin", "smax"):
            assert fx[k] == fy[k], (n, k)
        for k in ("ra1", "rv2", "rk4"):
            assert fx[k] == pytest.approx(fy[k], rel=1e-4), (n, k)
        sx, sy = x["selection"], y["selection"]
        for k in ("codec", "eb_abs", "eb_sz", "vr", "r_sp"):
            assert sx[k] == sy[k], (n, k)
        for k in ("br_sz", "br_zfp"):
            assert sx[k] == pytest.approx(sy[k], abs=5e-3), (n, k)


POLICIES = {
    "accuracy": (Policy.fixed_accuracy(eb_rel=1e-3), RPolicy.fixed_accuracy(eb_rel=1e-3)),
    "set": (
        PolicySet(default=Policy.fixed_accuracy(eb_rel=1e-4),
                  rules=[("b", Policy.raw()), ("opt/*", Policy.fixed_accuracy(eb_rel=1e-2))]),
        RPolicySet(default=RPolicy.fixed_accuracy(eb_rel=1e-4),
                   rules=[("b", RPolicy.raw()), ("opt/*", RPolicy.fixed_accuracy(eb_rel=1e-2))]),
    ),
}


@pytest.mark.parametrize("which", sorted(POLICIES))
def test_data_bin_and_manifest_equal_reference(tmp_path, which):
    pol, rpol = POLICIES[which]
    port, ref = _trees()
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    CheckpointManager(CheckpointConfig(pd, policy=pol, workers=0, cache=True), **CPU).save(3, port)
    RManager(RConfig(rd, policy=rpol, workers=0, cache=True)).save(3, ref)
    assert _data(pd, 3) == _data(rd, 3)
    assert _untimed(_manifest(pd, 3)) == _untimed(_manifest(rd, 3))
    _same_cache(_manifest(pd, 3)["decision_cache"], _manifest(rd, 3)["decision_cache"])
    rows = _manifest(pd, 3)["fields"]
    assert {r["codec"] for r in rows} >= {"sz", "none", "raw"}


def test_each_side_restores_the_others_step_and_cache(tmp_path):
    pol, rpol = POLICIES["accuracy"]
    port, ref = _trees()
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    RManager(RConfig(rd, policy=rpol, cache=True)).save(1, ref)
    CheckpointManager(CheckpointConfig(pd, policy=pol, cache=True), **CPU).save(1, port)
    # the port restores the reference's step, and its cache: the next save hits
    pm = CheckpointManager(CheckpointConfig(rd, policy=pol, cache=True), **CPU)
    step, got = pm.restore()
    _, want = RManager(RConfig(rd, policy=rpol)).restore()
    assert step == 1 and set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        if w.dtype == ml_dtypes.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16)), name
        else:
            assert np.array_equal(g.numpy(), np.asarray(w), equal_nan=True), name
    pm.cache.reset_stats()
    pm.save(2, port)
    assert pm.cache.stats()["misses"] == pm.cache.stats()["invalidations"] == 0
    assert pm.cache.stats()["hits"] == len(pm.cache.entries) > 0
    assert _data(rd, 2) == _data(rd, 1)
    # the reference restores the port's step, and its cache
    rm = RManager(RConfig(pd, policy=rpol, cache=True))
    step, back = rm.restore()
    _, mine = CheckpointManager(CheckpointConfig(pd, policy=pol), **CPU).restore()
    for name, w in back.items():
        m = mine[name]
        if w.dtype == ml_dtypes.bfloat16:
            assert np.array_equal(m.view(torch.int16).numpy(), w.view(np.int16)), name
        else:
            assert np.array_equal(m.numpy(), np.asarray(w), equal_nan=True), name
    rm.cache.reset_stats()
    rm.save(2, ref)
    assert rm.cache.stats()["hits"] == len(rm.cache.entries) > 0
    assert rm.cache.stats()["misses"] == rm.cache.stats()["invalidations"] == 0


def test_restore_within_bound_raw_bit_for_bit(tmp_path):
    port, _ = _trees()
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), policy=POLICIES["accuracy"][0]), **CPU)
    mgr.save(0, port)
    man = _manifest(str(tmp_path), 0)
    _, flat = mgr.restore()
    rows = {fl["name"]: fl for fl in man["fields"]}
    assert rows["opt/m"]["codec"] == "none"  # a bare Policy keeps opt/* raw
    src = _arrays()
    for name, fl in rows.items():
        y = flat[name]
        if fl["codec"] in ("sz", "zfp"):
            err = float(np.max(np.abs(y.double().numpy() - np.asarray(src[name], np.float64))))
            assert err <= fl["eb"], name
        elif fl["codec"] == "none" and name not in ("bf16", "opt/m"):
            assert np.array_equal(y.numpy(), np.asarray(src[name])), name
    flat["w"] += 1  # restored leaves are writeable
    step, tree = mgr.restore_tree(port)
    assert step == 0 and tree["bf16"].dtype == torch.bfloat16
    assert torch.equal(tree["bf16"].view(torch.int16), port["bf16"].view(torch.int16))
    assert tree["lr"].dtype == torch.float64 and float(tree["lr"]) == 3e-4


def test_restore_tree_decodes_only_the_templates_fields(tmp_path, monkeypatch):
    """A flat step restored into a template of some of its leaves decodes
    those alone, each equal to the whole `restore()`'s."""
    port, _ = _trees()
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), policy=POLICIES["accuracy"][0]), **CPU)
    mgr.save(0, port)
    lossy = {fl["name"] for fl in _manifest(str(tmp_path), 0)["fields"]
             if fl["codec"] in ("sz", "zfp")}
    assert {"w", "vol"} <= lossy
    _, whole = mgr.restore()
    decoded = []
    real = p_sel.decompress
    monkeypatch.setattr(p_sel, "decompress", lambda cf, **kw: decoded.append(cf.shape) or real(cf, **kw))
    step, tree = mgr.restore_tree({"w": port["w"], "ids": port["ids"], "lr": port["lr"]})
    assert step == 0 and decoded == [tuple(port["w"].shape)]
    for name in ("w", "ids", "lr"):
        assert torch.equal(tree[name], whole[name]), name


def test_target_mode_rows_record_quality(tmp_path):
    port, _ = _trees()
    pol = PolicySet(default=Policy.fixed_accuracy(eb_rel=1e-3),
                    rules=[("vol", Policy.fixed_ratio(8.0)), ("w", Policy.fixed_psnr(60.0))])
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), policy=pol, cache=True), **CPU)
    mgr.save(0, port)
    mgr.save(1, port)
    rows = {fl["name"]: fl for fl in _manifest(str(tmp_path), 1)["fields"]}
    assert rows["vol"]["quality"]["mode"] == "fixed_ratio"
    assert rows["w"]["quality"]["target"] == 60.0
    assert "quality" not in rows["b"]
    assert mgr.cache.events["vol"] == mgr.cache.events["w"] == "hit"


def test_checkpoint_manager_persists_and_resumes_warm(tmp_path):
    port, _ = _trees()
    cfg = CheckpointConfig(directory=str(tmp_path), policy=POLICIES["accuracy"][0], cache=True)
    mgr = CheckpointManager(cfg, **CPU)
    mgr.save(0, port)
    mgr.save(1, port)
    n = len(mgr.cache.entries)
    assert mgr.cache.stats()["hits"] == n > 0

    def rows(step):
        return {f["name"]: (f["codec"], f["nbytes"], f["eb"])
                for f in _manifest(str(tmp_path), step)["fields"]}

    assert rows(0) == rows(1)
    assert len(_manifest(str(tmp_path), 1)["decision_cache"]["entries"]) == n
    mgr2 = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), policy=POLICIES["accuracy"][0], cache=True), **CPU)
    step, flat = mgr2.restore()
    assert step == 1 and set(flat) == set(rows(1))
    mgr2.save(2, port)
    assert mgr2.cache.stats()["hits"] == n
    assert rows(2) == rows(0)


def test_cache_off_by_default_manifest_clean(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), policy=POLICIES["accuracy"][0]), **CPU)
    mgr.save(0, _trees()[0])
    assert "decision_cache" not in _manifest(str(tmp_path), 0)
    assert mgr.cache is None
    shared = DecisionCache(tolerance=0.01)
    assert CheckpointManager(CheckpointConfig(str(tmp_path), cache=shared), **CPU).cache is shared


def test_workers_give_the_serial_bytes(tmp_path):
    port, _ = _trees()
    for w in (0, 4):
        CheckpointManager(CheckpointConfig(
            str(tmp_path / str(w)), policy=POLICIES["accuracy"][0], workers=w), **CPU).save(0, port)
    assert _data(str(tmp_path / "0"), 0) == _data(str(tmp_path / "4"), 0)


def test_async_save_snapshots_at_the_call(tmp_path):
    """A tensor overwritten in place after `async_save` returns is saved
    with the values it had at the call."""
    port, _ = _trees()
    w = torch.from_numpy(port["w"].copy())
    tree = dict(port, w=w)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), policy=POLICIES["accuracy"][0]), **CPU)
    thread = mgr.async_save(5, tree)
    w.mul_(1000.0)
    mgr.wait()
    assert thread.save_result["path"].endswith("step_000000005")
    _, flat = mgr.restore()
    eb = next(fl["eb"] for fl in _manifest(str(tmp_path), 5)["fields"] if fl["name"] == "w")
    assert float((flat["w"].double() - torch.from_numpy(port["w"]).double()).abs().max()) <= eb


def test_keep_n_prunes_and_collects_torn_writes(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(CheckpointConfig(d, keep_n=2, policy=POLICIES["accuracy"][0]), **CPU)
    tree = {"w": _arrays()["w"]}
    os.makedirs(os.path.join(d, ".tmp_step_000000001_999"))  # a crash's leftover
    os.makedirs(os.path.join(d, ".tmp_step_000000009_999"))  # may be in flight
    for step in range(4):
        mgr.save(step, tree)
    left = sorted(os.listdir(d))
    assert [x for x in left if x.startswith("step_")] == ["step_000000002", "step_000000003"]
    assert ".tmp_step_000000001_999" not in left and ".tmp_step_000000009_999" in left
    assert mgr.latest_step() == 3


def test_legacy_kwargs_warn_and_map_onto_a_policy(tmp_path):
    with pytest.warns(DeprecationWarning):
        cfg = CheckpointConfig(str(tmp_path), eb_rel=1e-3)
    assert cfg.policy == Policy.fixed_accuracy(eb_rel=1e-3)
    with pytest.warns(DeprecationWarning):
        assert CheckpointConfig(str(tmp_path), policy=1e-3).policy == Policy.fixed_accuracy(eb_rel=1e-3)
    with pytest.raises(ValueError, match="not both"):
        CheckpointConfig(str(tmp_path), policy=Policy.fixed_accuracy(), eb_rel=1e-3)


@pytest.fixture
def one_rank_job():
    """A one-rank gloo job in this process (a mesh needs a process group)."""
    dist.initialize("gloo", master_port=0, rank=0, world_size=1)
    yield
    dist.shutdown()


def test_not_ported_layouts_raise_naming_item_14(tmp_path, one_rank_job):
    """Item 14a is ported: ``sharded=True`` saves the segment layout (plain
    tensors ride one gathered segment each), the reference reads it, a v2
    segments manifest restores, and `restore_tree(shardings=)` places the
    leaves on a one-rank mesh as DTensors. Compute under a mesh (14b) is
    ported too: `activate` binds the activation constraint for its body and
    unbinds it after."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime import sharding as rsh

    d = str(tmp_path / "s")
    tree = {"w": _arrays()["w"], "ids": np.arange(64, dtype=np.int32).reshape(8, 8)}
    mgr = CheckpointManager(
        CheckpointConfig(d, sharded=True, policy=Policy.fixed_accuracy(eb_rel=1e-3)), **CPU
    )
    mgr.save(0, tree)
    man = _manifest(d, 0)
    assert man["version"] == 3 and man["layout"] == "segments" and man["hosts"] == [0]
    assert {f["name"]: len(f["segments"]) for f in man["fields"]} == {"ids": 1, "w": 1}
    _, got = mgr.restore()
    _, ref = RManager(RConfig(d)).restore()
    for name in tree:
        np.testing.assert_array_equal(got[name].numpy(), ref[name])
    np.testing.assert_array_equal(got["ids"].numpy(), tree["ids"])
    v2 = dict(man, version=2)
    v2.pop("layout"), v2.pop("policy")
    with open(os.path.join(d, "step_000000000", "manifest.json"), "w") as f:
        json.dump(v2, f)
    _, again = mgr.restore()
    for name in tree:
        assert torch.equal(again[name], got[name])
    mesh = make_local_mesh(device="cpu")
    shardings = {"w": rsh.NamedSharding(mesh, rsh.spec_to_placements(mesh, ("data", None))),
                 "ids": None}
    _, placed = mgr.restore_tree(tree, shardings=shardings)
    assert isinstance(placed["w"], DTensor) and placed["w"].device_mesh is mesh
    assert torch.equal(placed["w"].to_local(), got["w"])
    assert not isinstance(placed["ids"], DTensor) and torch.equal(placed["ids"], got["ids"])
    from repro_torch.models import nn as mnn

    with rsh.activate(mesh, rsh.TRAIN_RULES):
        assert mnn.shard_fn() is not None and mnn.shard_fn().mesh is mesh
        laid = mnn.shard(got["w"], "batch", None)
        assert isinstance(laid, DTensor) and laid.device_mesh is mesh
        assert rsh.spec_entries(laid) == ("data", None)
        assert torch.equal(laid.to_local(), got["w"])
    assert mnn.shard_fn() is None
    assert mnn.shard(got["w"], "batch", None) is got["w"]


def test_without_cuda_the_default_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(CheckpointConfig(str(tmp_path)))


# -- the contracts of tests/test_checkpoint_async.py -----------------------


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": np.cumsum(rng.standard_normal((96, 96)), axis=0).astype(np.float32),
        "b": rng.standard_normal((96,)).astype(np.float32),
    }


def _mgr(tmp_path, pol=None, **kw):
    pol = pol or Policy.fixed_accuracy(eb_rel=1e-3)
    return CheckpointManager(CheckpointConfig(directory=str(tmp_path), policy=pol, **kw), **CPU)


def _boom(exc):
    def boom(*a, **k):
        raise exc

    return boom


def test_async_save_surfaces_encoder_exception(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path)
    monkeypatch.setattr(p_sel, "encode_with_selection", _boom(ValueError("encoder exploded")))
    mgr.async_save(1, _tree())
    with pytest.raises(ValueError, match="encoder exploded"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_async_save_recovers_after_failure(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path)
    orig = p_sel.encode_with_selection
    monkeypatch.setattr(p_sel, "encode_with_selection", _boom(RuntimeError("transient")))
    mgr.async_save(1, _tree())
    with pytest.raises(RuntimeError):
        mgr.wait()
    monkeypatch.setattr(p_sel, "encode_with_selection", orig)
    mgr.async_save(2, _tree())
    mgr.wait()
    step, flat = mgr.restore()
    assert step == 2 and "w" in flat
    mgr.wait()  # the old exception is not replayed


def test_sync_save_propagates_inline(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path)
    monkeypatch.setattr(p_sel, "encode_with_selection", _boom(ValueError("encoder exploded")))
    with pytest.raises(ValueError, match="encoder exploded"):
        mgr.save(1, _tree())


def _flaky_barrier(fail_first_n):
    calls = []

    def barrier(name, timeout_s):
        calls.append(name)
        if len(calls) <= fail_first_n:
            raise dist.BarrierTimeout(f"barrier {name!r} timed out (injected)")

    return barrier, calls


def test_save_requeues_once_on_barrier_timeout(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, Policy.fixed_psnr(50.0))
    barrier, calls = _flaky_barrier(fail_first_n=1)
    monkeypatch.setattr(dist, "barrier", barrier)
    path = mgr.save(1, _tree())
    assert mgr.last_save_retries == 1
    assert len(calls) == 2 and calls[0] != calls[1]
    step, flat = mgr.restore()
    assert step == 1 and tuple(flat["w"].shape) == (96, 96)
    assert path.endswith("step_000000001")


@pytest.mark.parametrize("retries,attempts", [(2, 3), (0, 1)])
def test_save_persistent_barrier_timeout_raises(tmp_path, monkeypatch, retries, attempts):
    mgr = _mgr(tmp_path, Policy.fixed_psnr(50.0), save_retries=retries)
    barrier, calls = _flaky_barrier(fail_first_n=10**9)
    monkeypatch.setattr(dist, "barrier", barrier)
    with pytest.raises(dist.BarrierTimeout):
        mgr.save(1, _tree())
    assert len(calls) == attempts and len(set(calls)) == attempts


def test_async_save_result_reports_retries(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, Policy.fixed_psnr(50.0))
    barrier, _ = _flaky_barrier(fail_first_n=1)
    monkeypatch.setattr(dist, "barrier", barrier)
    thread = mgr.async_save(4, _tree())
    mgr.wait()
    assert thread.save_result["retries"] == 1
    assert thread.save_result["path"].endswith("step_000000004")
    assert mgr.restore()[0] == 4


def test_async_save_persistent_timeout_surfaces_in_wait(tmp_path, monkeypatch):
    mgr = _mgr(tmp_path, Policy.fixed_psnr(50.0), save_retries=1)
    barrier, calls = _flaky_barrier(fail_first_n=10**9)
    monkeypatch.setattr(dist, "barrier", barrier)
    thread = mgr.async_save(5, _tree())
    with pytest.raises(dist.BarrierTimeout):
        mgr.wait()
    assert thread.save_result is None
    assert len(calls) == 2
