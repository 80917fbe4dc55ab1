"""Rank-side scenarios of the port's multi-process tests.

`tests/test_torch_sharded.py`, `tests/test_torch_multihost.py` and the
`cuda` test start these through `repro_torch.launch.mhrun`, one fresh
interpreter per rank:

    python tests/torch_shard_worker.py SPEC.json

Imports neither JAX nor the reference package: each rank runs the port
alone, and the pytest process holds what it reports against the reference.
Every scenario returns a JSON payload; bulky results (segments, restored
values) go to pickles in the job's output dir.
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np

EB_REL = 1e-3


def mixed_arrays(seed: int = 0) -> dict:
    """name -> (array, spec or None): the tree of the reference's
    `tests/test_sharded_compress.py::_mixed_tree`, drawn in its order, with
    its layouts (spec None: a host leaf)."""
    rng = np.random.default_rng(seed)

    def walk(shape, axis=0):
        return np.cumsum(rng.standard_normal(shape), axis=axis).astype(np.float32)

    return {
        "dp": (walk((128, 96)), ("data", None)),
        "tp": (walk((96, 128)), (None, "model")),
        "both": (walk((64, 64, 32)), ("data", "model", None)),
        "vol": (walk((32, 64, 64), 2), ("data", None, "model")),
        "repl": (walk((128, 64)), (None, None)),
        "conv": (walk((2, 3, 8, 32, 32)), (None,) * 5),
        "rough": (rng.standard_normal((96, 96)).astype(np.float32), ("data", None)),
        "uneven": (walk((100, 64)), ("data", None)),
        "tiny": (walk((8,)), (None,)),
        "const": (np.full((64, 64), 3.0, np.float32), ("data", None)),
        "ids": (np.arange(1024, dtype=np.int32).reshape(32, 32), ("data", None)),
        "step": (np.array(7, np.int64), None),
    }


FLOATS = ["both", "conv", "const", "dp", "repl", "rough", "tiny", "tp", "uneven", "vol"]

#: (label, policy spec, reconcile) of every `plan_tree` the tests compare
MODES = [
    ("stats", ("fixed_accuracy", EB_REL), "stats"),
    ("samples", ("fixed_accuracy", EB_REL), "samples"),
    ("fixed_psnr", ("fixed_psnr", 60.0), "auto"),
    ("fixed_ratio", ("fixed_ratio", 6.0), "auto"),
]

#: (shape, spec) of the layout-eligibility cases of the reference's
#: `test_layout_eligibility_rules`, and two more
ELIGIBILITY = [
    ((100, 64), ("data", None)),
    ((100, 64), (None, "model")),
    ((8, 64), ("model", None)),
    ((4, 8, 16, 16), (None, "data", None, None)),
    ((4, 8, 16, 16), ("data", None, None, None)),
    ((64, 64, 32), ("data", "model", None)),
    ((64, 64), (("data", "model"), None)),
]


_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def run_job(scenario: str, n: int, workdir, args=None, timeout_s: float = 120.0):
    """Run `scenario` as an `n`-rank gloo job (this file, one interpreter a
    rank) under a hard timeout; every rank's payload, or an
    AssertionError with the failed ranks' output."""
    from repro_torch.launch import mhrun

    return mhrun.require_success(launch(scenario, n, workdir, args, timeout_s))


def launch(scenario: str, n: int, workdir, args=None, timeout_s: float = 120.0):
    from repro_torch.launch import mhrun

    return mhrun.run(
        [sys.executable, os.path.abspath(__file__)], n, scenario=scenario, args=args or {},
        timeout_s=timeout_s, workdir=str(workdir),
        extra_env={"PYTHONPATH": _SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   "OMP_NUM_THREADS": "2"},
    )


def policy(spec):
    from repro_torch.core import Policy

    mode, target = spec
    if mode == "fixed_accuracy":
        return Policy.fixed_accuracy(eb_rel=target)
    return getattr(Policy, mode)(target)


def plan_record(p) -> dict:
    s = p.selection
    return dict(codec=s.codec, eb_abs=s.eb_abs, eb_sz=s.eb_sz, br_sz=s.br_sz, br_zfp=s.br_zfp,
                psnr_target=s.psnr_target, vr=s.vr, r_sp=s.r_sp, reconcile=p.reconcile,
                path=p.path)


def _lay(mesh, spec):
    from repro_torch.runtime import sharding as rsh

    return rsh.NamedSharding(mesh, rsh.spec_to_placements(mesh, spec))


def _place(mesh, arrays: dict) -> dict:
    from repro_torch.runtime import dist

    return {k: x if spec is None else dist.put_global(x, _lay(mesh, spec))
            for k, (x, spec) in arrays.items()}


def _dump(spec, name: str, obj) -> None:
    with open(os.path.join(spec["outdir"], name), "wb") as f:
        pickle.dump(obj, f)


def scenario_sharded(spec: dict, rank: int) -> dict:
    """The shard-local engine on the mixed tree over a (2, 2) mesh:
    decisions under every mode, each rank's owned segments, eligibility,
    block ownership, and a `compress_pytree` round trip."""
    import torch

    from repro_torch.core import compress_pytree, decompress_pytree
    from repro_torch.core import estimator as est
    from repro_torch.core import sharded as shd
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import dist

    torch.set_num_threads(2)
    mesh = make_emulated_mesh((2, 2), device="cpu")
    arrays = mixed_arrays()
    tree = _place(mesh, arrays)
    out: dict = {"plans": {}, "seconds": {}}
    samples_plans = None
    for label, pol, rec in MODES:
        t0 = time.perf_counter()
        plans = shd.plan_tree([tree[k] for k in FLOATS], policy(pol), reconcile=rec, device="cpu")
        out["seconds"][label] = time.perf_counter() - t0
        out["plans"][label] = {k: plan_record(p) for k, p in zip(FLOATS, plans)}
        if label == "samples":
            samples_plans = plans
    # the warm path: a DecisionCache fingerprints the engine fields on the
    # merged moments; an identical second call replays every one of them
    from repro_torch.core.decision_cache import DecisionCache

    cache = DecisionCache()
    pol = policy(("fixed_accuracy", EB_REL))
    fields = [tree[k] for k in FLOATS]
    cold = shd.plan_tree(fields, pol, cache=cache, names=FLOATS, device="cpu")
    warm = shd.plan_tree(fields, pol, cache=cache, names=FLOATS, device="cpu")
    out["warm"] = dict(
        reconcile=[p.reconcile for p in warm],
        equal=[a.selection == b.selection for a, b in zip(cold, warm)],
        events=dict(cache.events),
    )
    # each rank's owned segments under the samples decisions (host coder);
    # a gathered field is gathered on every rank (a collective), host 0 encodes
    segs = {}
    for k, p in zip(FLOATS, samples_plans):
        x = tree[k] if p.sharded else dist.to_numpy(tree[k])
        segs[k] = [(s.start, s.stop, s.codec, s.data) for s in shd.encode_plan(x, p, host=rank)]
    _dump(spec, f"segments.{rank}.pkl", segs)
    # layout eligibility
    rng = np.random.default_rng(4)
    elig = []
    for shape, sp in ELIGIBILITY:
        x = dist.put_global(rng.standard_normal(shape).astype(np.float32), _lay(mesh, sp))
        lay = shd.analyze(x)
        elig.append(None if lay is None else dict(
            view_shape=list(lay.view_shape), local_view=list(lay.local_view),
            axis_of_dim=list(lay.axis_of_dim),
            segs=[[list(s.start), list(s.stop), list(s.devices)] for s in lay.segs],
        ))
    out["eligibility"] = elig
    out["host_array_layout"] = shd.analyze(np.zeros((64, 64), np.float32)) is None
    # block ownership of two layouts
    owned = {}
    for k in ("dp", "repl", "vol"):
        lay = shd.analyze(tree[k])
        starts = est.block_starts(lay.view_shape, 0.05)
        owned[k] = {str(r): [a.tolist(), b.tolist()] for r, (a, b) in shd._owned_starts(lay, starts).items()}
    out["owned"] = owned
    # compress_pytree(sharded) round trip on every rank
    ct = compress_pytree(tree, policy(("fixed_accuracy", EB_REL)), device="cpu", workers=2)
    back = decompress_pytree(ct, device="cpu")
    rt = {}
    for k, (x, _) in arrays.items():
        cf = ct.fields[k]
        y = back[k].numpy()
        sel = getattr(cf, "selection", None)
        err = float(np.max(np.abs(y.astype(np.float64) - x.astype(np.float64)))) if x.size else 0.0
        rt[k] = dict(
            kind=type(cf).__name__, codec=cf.codec, dtype=str(y.dtype), shape=list(y.shape),
            segments=len(getattr(cf, "segments", [])), max_err=err,
            eb=None if sel is None or cf.codec in ("raw",) else sel.eb_abs,
            exact=bool(np.array_equal(y, x)),
        )
    out["roundtrip"] = rt
    out["backend"] = dist.backend()
    return out


def ckpt_arrays() -> dict:
    """The checkpoint tests' tree: the mixed tree and Adam-like moments
    (raw under a bare Policy: ``opt/*``), laid out like the weights."""
    arrays = dict(mixed_arrays())
    rng = np.random.default_rng(1)
    for k in ("dp", "tp", "both"):
        x, spec = arrays[k]
        arrays[f"opt/{k}"] = ((0.01 * rng.standard_normal(x.shape)).astype(np.float32), spec)
    return arrays


def nest(flat: dict) -> dict:
    """{"opt/dp": v} -> {"opt": {"dp": v}} (the leaf names come back)."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p_ in parents:
            node = node.setdefault(p_, {})
        node[leaf] = v
    return out


def _flat(tree) -> dict:
    from repro_torch.core import pytree

    return {pytree.leaf_name(p): v for p, v in pytree.flatten_with_path(tree)[0]}


def _check_placed(placed: dict, full: dict, meshes_ok) -> dict:
    """Per leaf: whether this rank's shard of `placed` equals its box of the
    mesh-free restore `full`, and whether it sits on the wanted mesh."""
    from repro_torch.runtime import sharding as rsh

    out = {}
    for k, v in placed.items():
        want = full[k]
        if hasattr(v, "device_mesh"):
            st, sp = rsh.local_box(rsh.NamedSharding(v.device_mesh, v.placements), tuple(want.shape))
            box = want[tuple(slice(a, b) for a, b in zip(st, sp))]
            out[k] = bool(meshes_ok(v.device_mesh)) and bool(
                np.array_equal(v.to_local().cpu().numpy(), box.cpu().numpy()))
        else:
            out[k] = bool(np.array_equal(np.asarray(v.cpu()), want.cpu().numpy()))
    return out


def scenario_save_restore(spec: dict, rank: int) -> dict:
    """A cooperative sharded save of the checkpoint tree on a (2, 2) mesh,
    the mesh-free restore (dumped by rank 0), elastic `restore_tree` under
    (4, 1), (1, 4) and no mesh, and the reference's checkpoint in
    `args.ref_dir` restored (dumped by rank 0, and placed on (2, 2))."""
    import torch

    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.launch.mesh import make_emulated_mesh

    torch.set_num_threads(2)
    a = spec["args"]
    meshes = {s: make_emulated_mesh(s, device="cpu") for s in ((2, 2), (4, 1), (1, 4))}
    arrays = ckpt_arrays()
    tree = nest(_place(meshes[(2, 2)], arrays))
    mgr = CheckpointManager(
        CheckpointConfig(a["directory"], policy=policy(("fixed_accuracy", EB_REL)), sharded=True,
                         barrier_timeout_s=60.0),
        device="cpu",
    )
    t0 = time.perf_counter()
    path = mgr.save(1, tree)
    out: dict = {"save_seconds": time.perf_counter() - t0, "path": path}
    _, full = mgr.restore()
    if rank == 0:
        _dump(spec, "port_restore.pkl", {k: v.numpy() for k, v in full.items()})
    placed = {}
    for shape in ((4, 1), (1, 4)):
        m = meshes[shape]
        shardings = nest({k: None if sp is None else _lay(m, sp) for k, (x, sp) in arrays.items()})
        _, got = mgr.restore_tree(tree, shardings=shardings)
        placed[str(shape)] = _check_placed(_flat(got), full, lambda dm, m=m: dm is m)
        out[f"stats {shape}"] = mgr.last_restore_stats
    _, got = mgr.restore_tree(tree)
    placed["none"] = _check_placed(_flat(got), full, lambda dm: False)
    out["placed"] = placed
    # an async save snapshots the shards at the call: an in-place write
    # after it must not reach step 2, which restores as step 1 does
    thread = mgr.async_save(2, tree)
    for v in _flat(tree).values():
        if hasattr(v, "device_mesh") and v.dtype.is_floating_point:
            v.to_local().add_(1.0)
    mgr.wait()
    _, step2 = mgr.restore(2)
    out["async"] = dict(path=thread.save_result["path"],
                        equal=all(torch.equal(step2[k], full[k]) for k in full))
    ref = CheckpointManager(CheckpointConfig(a["ref_dir"]), device="cpu")
    _, ref_full = ref.restore()
    if rank == 0:
        _dump(spec, "ref_restore.pkl", {k: v.numpy() for k, v in ref_full.items()})
    m = meshes[(2, 2)]
    shardings = nest({k: None if sp is None else _lay(m, sp) for k, (x, sp) in arrays.items()})
    _, got = ref.restore_tree(tree, shardings=shardings)
    out["ref_placed"] = _check_placed(_flat(got), ref_full, lambda dm: dm is m)
    return out


def scenario_owner(spec: dict, rank: int) -> dict:
    """Two ranks on a (1, 2) mesh: a leaf replicated over both ranks is
    written once, by the lowest rank; a leaf split over 'model' by both."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import dist

    mesh = make_emulated_mesh((1, 2), device="cpu")
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.standard_normal((64, 64)), axis=0).astype(np.float32)
    tree = {
        "repl": dist.put_global(x, _lay(mesh, ("data", None))),
        "split": dist.put_global(x, _lay(mesh, (None, "model"))),
        "opt": {"repl": dist.put_global(x, _lay(mesh, (None, None)))},
    }
    mgr = CheckpointManager(
        CheckpointConfig(spec["args"]["directory"], policy=policy(("fixed_accuracy", EB_REL)),
                         sharded=True, barrier_timeout_s=30.0),
        device="cpu",
    )
    path = mgr.save(1, tree)
    return dict(path=path)


def scenario_fault(spec: dict, rank: int) -> dict:
    """Two ranks save step 1; at step 2 the victim exits before its commit
    marker. The survivor must raise `BarrierTimeout` within the bound, and
    step 2 must never be promoted."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import dist

    a = spec["args"]
    mesh = make_emulated_mesh((2, 1), device="cpu")
    x = np.cumsum(np.random.default_rng(3).standard_normal((64, 64)), axis=0).astype(np.float32)
    tree = {"w": dist.put_global(x, _lay(mesh, ("data", None)))}
    mgr = CheckpointManager(
        CheckpointConfig(a["directory"], policy=policy(("fixed_accuracy", EB_REL)), sharded=True,
                         barrier_timeout_s=float(a["barrier_timeout_s"]), save_retries=0),
        device="cpu",
    )
    mgr.save(1, tree)
    if rank == int(a["victim"]):
        def die(items, encode):
            os._exit(17)
            yield  # noqa: unreachable - a generator, as the writer iterates it

        mgr._encoded_in_order = die
    t0 = time.perf_counter()
    err = None
    try:
        mgr.save(2, tree)
    except dist.BarrierTimeout:
        err = "BarrierTimeout"
    waited = time.perf_counter() - t0
    _, flat = mgr.restore()
    return dict(
        err=err, waited=waited, latest=mgr.latest_step(),
        step2_promoted=os.path.exists(os.path.join(a["directory"], f"step_{2:09d}")),
        fields_restored=len(flat),
    )


def scenario_card(spec: dict, rank: int) -> dict:
    """Two ranks on one card over gloo, a (2, 1) mesh: a 2-D and a 3-D
    field split over 'data' decide shard-locally (samples, and stats) as
    the unsharded `select_many` on the card does, each rank's segments run
    through the device encoder (K1/K2) and decode within eb. A field split
    into 250-wide shards (not 4-aligned) takes the gather path through
    `compress_pytree(sharded=True, device_encode=True)` with no device
    given: each rank encodes its gathered copy with K1 on the card."""
    import torch

    from repro_torch.core import Policy, compress_pytree, decompress_pytree, select_many
    from repro_torch.core import sharded as shd
    from repro_torch.kernels import lorenzo
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import dist

    mesh = make_emulated_mesh((2, 1))
    rng = np.random.default_rng(5)
    fields = {
        "atm": (np.cumsum(rng.standard_normal((256, 512)), axis=1).astype(np.float32), ("data", None)),
        "vol": (np.cumsum(rng.standard_normal((64, 64, 64)), axis=2).astype(np.float32), ("data", None, None)),
    }
    tree = _place(mesh, fields)
    names = list(fields)
    pol = Policy.fixed_accuracy(eb_rel=1e-4)
    dev = torch.device("cuda", torch.cuda.current_device())
    want = select_many([fields[k][0] for k in names], policy=pol, device=dev)
    out: dict = {"device": [str(tree[k].to_local().device) for k in names]}
    for rec in ("samples", "stats"):
        plans = shd.plan_tree([tree[k] for k in names], pol, reconcile=rec)
        out[rec] = {k: dict(plan_record(p), equal=p.selection == w)
                    for k, p, w in zip(names, plans, want)}
        if rec == "samples":
            samples = plans
    lorenzo.reset_launches()
    errs = {}
    for k, p in zip(names, samples):
        x, _ = fields[k]
        for s in shd.encode_plan(tree[k], p, host=rank, device_encode=True):
            y = shd.decode_segments(tuple(b - a for a, b in zip(s.start, s.stop)), [
                shd.Segment((0,) * len(s.start), tuple(b - a for a, b in zip(s.start, s.stop)),
                            s.codec, s.data)])
            box = x.reshape(p.view_shape)[tuple(slice(a, b) for a, b in zip(s.start, s.stop))]
            errs[f"{k}{list(s.start)}"] = [s.codec, float(np.max(np.abs(y - box))), p.selection.eb_abs]
    out["launches"] = dict(lorenzo.LAUNCHES)
    out["segments"] = errs
    # the gather path: a 2-D field over 'data' on dim 1, 250-wide shards
    hur = np.cumsum(rng.standard_normal((256, 500)), axis=0).astype(np.float32)
    (plan,) = shd.plan_tree([_place(mesh, {"h": (hur, (None, "data"))})["h"]], pol)
    lorenzo.reset_launches()
    ct = compress_pytree(_place(mesh, {"hur": (hur, (None, "data"))}), pol, sharded=True,
                         device_encode=True)
    back = decompress_pytree(ct, device="cpu")["hur"].numpy()
    out["gather"] = dict(path=plan.path, codec=ct.fields["hur"].codec,
                         launches=dict(lorenzo.LAUNCHES),
                         err=float(np.max(np.abs(back - hur))), eb=plan.selection.eb_abs)
    out["backend"] = dist.backend()
    return out


SCENARIOS = {
    "card": scenario_card,
    "fault": scenario_fault,
    "owner": scenario_owner,
    "save_restore": scenario_save_restore,
    "sharded": scenario_sharded,
}


if __name__ == "__main__":
    from repro_torch.launch import mhrun

    sys.exit(mhrun.worker_main(sys.argv[-1], SCENARIOS))
