"""The port's multi-host segment checkpoint (`repro_torch.checkpoint`,
`CheckpointConfig(sharded=True)` on `torch.distributed`) against the
reference's, and its failure guarantees.

Jobs of real processes, one rank each, through
`repro_torch.launch.mhrun` (the scenarios of `tests/torch_shard_worker.py`)
over gloo on the CPU, each under a hard timeout:

* one module-scoped 4-rank cooperative save on a (2, 2) mesh, restored
  mesh-free, under (4, 1), (1, 4) and no mesh (`restore_tree(shardings=)`),
  and the reference's single-process 4-device sharded checkpoint of the
  same tree restored by the port; this process restores the port's
  checkpoint with the reference's `CheckpointManager.restore`, and the
  values must agree bit for bit both ways;
* a 2-rank job where a replicated shard is written once, by its lowest
  rank (`dist.owner_host`);
* a 2-rank job where one rank exits before its commit marker: the other
  raises `BarrierTimeout` within a short bound and nothing is promoted;
* a missing `commit.<h>` or a truncated `data.<h>.bin` raises
  `IncompleteCheckpointError`.
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.checkpoint import CheckpointConfig as RConfig
from repro.checkpoint import CheckpointManager as RManager
from repro.core import Policy as RPolicy
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager, IncompleteCheckpointError

sys.path.insert(0, os.path.dirname(__file__))
import torch_shard_worker as W  # noqa: E402

pytestmark = pytest.mark.usefixtures("emulated_devices")

BARRIER_S = 3.0


@pytest.fixture(scope="module")
def saved(tmp_path_factory, emulated_devices):
    """The reference's 4-device sharded checkpoint, then the port's 4-rank
    job: its own save and restores, and the reference's checkpoint."""
    root = tmp_path_factory.mktemp("multihost")
    mesh = Mesh(np.array(emulated_devices[:4]).reshape(2, 2), ("data", "model"))
    arrays = W.ckpt_arrays()
    ref_tree = W.nest({k: x if sp is None else jax.device_put(x, NamedSharding(mesh, P(*sp)))
                       for k, (x, sp) in arrays.items()})
    ref_dir = str(root / "ref")
    RManager(RConfig(ref_dir, policy=RPolicy.fixed_accuracy(eb_rel=W.EB_REL),
                     sharded=True)).save(1, ref_tree)
    port_dir = str(root / "port")
    payloads = W.run_job("save_restore", 4, root / "job",
                       dict(directory=port_dir, ref_dir=ref_dir))
    with open(root / "job" / "port_restore.pkl", "rb") as f:
        port_restore = pickle.load(f)
    with open(root / "job" / "ref_restore.pkl", "rb") as f:
        ref_restore = pickle.load(f)
    return dict(payloads=payloads, port_dir=port_dir, ref_dir=ref_dir,
                port_restore=port_restore, ref_restore=ref_restore, arrays=arrays)


def _manifest(d):
    with open(os.path.join(d, "step_000000001", "manifest.json")) as f:
        return json.load(f)


def test_cooperative_save_layout(saved):
    man = _manifest(saved["port_dir"])
    assert man["version"] == 3 and man["layout"] == "segments"
    assert man["hosts"] == [0, 1, 2, 3] and sorted(man["completion"]) == ["0", "1", "2", "3"]
    step = os.path.join(saved["port_dir"], "step_000000001")
    for h in range(4):
        assert os.path.exists(os.path.join(step, f"commit.{h}"))
        assert os.path.getsize(os.path.join(step, f"data.{h}.bin")) == man["completion"][str(h)]
    by_name = {f["name"]: f for f in man["fields"]}
    assert len(by_name["both"]["segments"]) == 4 and len(by_name["opt/both"]["segments"]) == 4
    assert by_name["opt/dp"]["codec"] == "none" and by_name["uneven"]["segments"][0]["host"] == 0
    # the segments tile every field's view exactly once
    for fl in man["fields"]:
        covered = sum(int(np.prod([b - a for a, b in zip(sg["start"], sg["stop"])]))
                      for sg in fl["segments"])
        assert covered == int(np.prod(fl["view_shape"] or [1])), fl["name"]
    # the decisions agree with the reference's on the same tree
    ref = {f["name"]: f for f in _manifest(saved["ref_dir"])["fields"]}
    for name, fl in by_name.items():
        assert fl["codec"] == ref[name]["codec"], name
        assert fl["eb"] == ref[name]["eb"], name


def test_reference_restores_the_port_checkpoint_bit_for_bit(saved):
    _, got = RManager(RConfig(saved["port_dir"])).restore(1)
    port = saved["port_restore"]
    assert sorted(got) == sorted(port)
    for name, v in port.items():
        np.testing.assert_array_equal(np.asarray(got[name]), v, err_msg=name)
        assert np.asarray(got[name]).dtype == v.dtype, name
    arrays = saved["arrays"]
    for name in ("ids", "opt/dp", "step"):
        np.testing.assert_array_equal(port[name], arrays[name][0], err_msg=name)


def test_port_restores_the_reference_checkpoint_bit_for_bit(saved):
    _, want = RManager(RConfig(saved["ref_dir"])).restore()
    got = saved["ref_restore"]
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[name]), err_msg=name)
    for p in saved["payloads"]:
        assert all(p["ref_placed"].values()), p["ref_placed"]


def test_async_sharded_save_snapshots_at_the_call(saved):
    for p in saved["payloads"]:
        assert p["async"]["path"].endswith("step_000000002") and p["async"]["equal"], p["async"]
    _, got = RManager(RConfig(saved["port_dir"])).restore(2)
    for name, v in saved["port_restore"].items():
        np.testing.assert_array_equal(np.asarray(got[name]), v, err_msg=name)


@pytest.mark.parametrize("target", ["(4, 1)", "(1, 4)", "none"])
def test_elastic_restore_tree(saved, target):
    for p in saved["payloads"]:
        placed = p["placed"][target]
        assert sorted(placed) == sorted(saved["arrays"]), target
        assert all(placed.values()), (target, placed)


def test_restore_reads_only_the_segments_a_rank_needs(saved):
    stats = [p["stats (4, 1)"] for p in saved["payloads"]]
    assert all(0 < s["segments_decoded"] <= s["segments_total"] for s in stats)
    assert any(s["segments_decoded"] < s["segments_total"] for s in stats)


def test_replicated_shard_written_once_by_lowest_rank(tmp_path):
    d = str(tmp_path / "ckpt")
    W.run_job("owner", 2, tmp_path / "job", dict(directory=d))
    man = _manifest(d)
    hosts = {f["name"]: [sg["host"] for sg in f["segments"]] for f in man["fields"]}
    assert hosts["repl"] == [0] and hosts["opt/repl"] == [0]
    assert hosts["split"] == [0, 1]
    step = os.path.join(d, "step_000000001")
    split = {sg["host"]: sg["nbytes"] for sg in next(
        f for f in man["fields"] if f["name"] == "split")["segments"]}
    assert os.path.getsize(os.path.join(step, "data.1.bin")) == split[1]


def test_rank_dying_before_commit_times_out_and_never_promotes(tmp_path):
    d = str(tmp_path / "ckpt")
    results = W.launch("fault", 2, tmp_path / "job",
                       dict(directory=d, victim=1, barrier_timeout_s=BARRIER_S), timeout_s=90.0)
    by_rank = {r.process_id: r for r in results}
    assert by_rank[1].returncode == 17 and by_rank[1].result is None
    survivor = by_rank[0]
    assert survivor.ok, survivor.output[-3000:]
    res = survivor.result
    assert res["err"] == "BarrierTimeout"
    assert BARRIER_S - 0.5 <= res["waited"] <= BARRIER_S + 5.0, res["waited"]
    assert res["latest"] == 1 and not res["step2_promoted"] and res["fields_restored"] == 1
    assert [x for x in os.listdir(d) if x.startswith("step_")] == ["step_000000001"]


@pytest.mark.parametrize("damage", ["missing_commit", "truncated_data"])
def test_incomplete_checkpoint_is_refused(saved, tmp_path, damage):
    d = str(tmp_path / "copy")
    shutil.copytree(saved["port_dir"], d)
    step = os.path.join(d, "step_000000001")
    if damage == "missing_commit":
        os.remove(os.path.join(step, "commit.2"))
    else:
        path = os.path.join(step, "data.0.bin")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 1)
    mgr = CheckpointManager(CheckpointConfig(d), device="cpu")
    with pytest.raises(IncompleteCheckpointError):
        mgr.restore(1)
    with pytest.raises(IncompleteCheckpointError):
        mgr.restore_tree({"dp": np.zeros((128, 96), np.float32)}, step=1)
    assert mgr.restore(2)[0] == 2  # the undamaged step still restores
