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


def run_job(scenario: str, n: int, workdir, args=None, timeout_s: float = 120.0, env=None):
    """Run `scenario` as an `n`-rank gloo job (this file, one interpreter a
    rank) under a hard timeout; every rank's payload, or an
    AssertionError with the failed ranks' output. `env` adds variables to
    the ranks' environment."""
    from repro_torch.launch import mhrun

    return mhrun.require_success(launch(scenario, n, workdir, args, timeout_s, env))


def launch(scenario: str, n: int, workdir, args=None, timeout_s: float = 120.0, env=None):
    from repro_torch.launch import mhrun

    return mhrun.run(
        [sys.executable, os.path.abspath(__file__)], n, scenario=scenario, args=args or {},
        timeout_s=timeout_s, workdir=str(workdir),
        extra_env={"PYTHONPATH": _SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   "OMP_NUM_THREADS": "2", **(env or {})},
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


def _spec(x) -> list:
    from repro_torch.runtime import sharding as rsh

    return [list(e) if isinstance(e, tuple) else e for e in rsh.spec_entries(x)]


def _case_weights(spec: dict, name: str, arch: str) -> dict:
    """The job's weights file `name`, its "{arch}" filled in."""
    return dict(np.load(os.path.join(spec["outdir"], name.replace("{arch}", arch))))


class _GatherLog:
    """Records, while entered, every host-staged gather of
    `runtime.sharding` (`_gather_local`): the mesh dim's name, the shard's
    shape and the gathered dim."""

    def __enter__(self):
        from repro_torch.runtime import sharding as rsh

        self.seen, self._orig = [], rsh._gather_local

        def logged(local, mesh, j, d, extent):
            self.seen.append((mesh.mesh_dim_names[j], list(local.shape), d))
            return self._orig(local, mesh, j, d, extent)

        rsh._gather_local = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.runtime import sharding as rsh

        rsh._gather_local = self._orig


def _moe_block(spec: dict, mesh, case: dict) -> dict:
    """One MoE block (`blocks.apply_moe`, `blocks.moe_routing`) under
    `SERVE_RULES` on `mesh`: the block's weights (`moe-NAME.npz`, laid out
    by `tree_shardings`), x (B, L, d) drawn from numpy seed 5 and split by
    batch: the gathered output, expert choices and kept flags."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.models import blocks, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    base = reduced_for_smoke(get_config(case["arch"]))
    cfg = dataclasses.replace(base, dtype="float32", moe=dataclasses.replace(base.moe, **case["moe"]))
    desc = blocks.desc_moe(cfg)
    lay = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rsh.SERVE_RULES, mesh,
                                   mnn.abstract_tree(desc)))
    weights = dict(np.load(os.path.join(spec["outdir"], f"moe-{case['name']}.npz")))
    p = nest({k: dist.put_global(torch.from_numpy(w), lay[k]) for k, w in weights.items()})
    x = np.random.default_rng(5).standard_normal(tuple(case["shape"]) + (cfg.d_model,))
    x = torch.as_tensor(x, dtype=torch.float32)
    with rsh.activate(mesh, rsh.SERVE_RULES):
        xd = dist.put_global(x, batch_shardings({"x": x}, mesh, x.shape[0])["x"])
        with _GatherLog() as gathers:
            y = blocks.apply_moe(p, xd, cfg)
        sel, kept = blocks.moe_routing(p, xd, cfg)
    return dict(y=dist.gather(y).numpy(), sel=dist.gather(sel).numpy(),
                kept=dist.gather(kept).numpy(), gathers=gathers.seen)


def frontend_inputs(cfg, batch: int, rng) -> dict:
    """The vision stub's patch embeddings or the encoder-decoder's frames
    (batch, frontend_len, d_model) float32, drawn from `rng` as
    `launch.serve.run_static` draws them after the prompts; {} for the
    other families."""
    name = "patch_embeds" if cfg.frontend == "vision" else "frames" if cfg.encdec else None
    if name is None:
        return {}
    return {name: rng.standard_normal((batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)}


def train_batch(cfg, dcfg, step: int) -> dict:
    """`data.synthetic_batch(dcfg, step)` and, for a vision or
    encoder-decoder config, its frontend inputs drawn from numpy seed
    100 + step (tests/test_torch_train_families.py's frames)."""
    from repro_torch.data import synthetic_batch

    return dict(synthetic_batch(dcfg, step),
                **frontend_inputs(cfg, dcfg.global_batch, np.random.default_rng(100 + step)))


def variant_config(arch: str, dtype: str, variant: str, overrides: dict | None = None):
    """The reduced `arch` (`reduced_for_smoke`, then `overrides`) in
    `dtype`, with the int8 KV cache for the dry run's 'kvq8' and 'combo'
    variants."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke

    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype=dtype, **(overrides or {}))
    return dataclasses.replace(cfg, kv_quant=variant in ("kvq8", "combo"))


def scenario_mesh_serve(spec: dict, rank: int) -> dict:
    """The decoder-only LMs served under `SERVE_RULES` on a mesh of the
    job's ranks: for each (dtype, batch) case of `args["arch"]` (weights
    `weights.npz`) or (arch, dtype, batch) case (`weights-ARCH.npz`), the
    reduced model's params, laid out by `tree_shardings`, through
    `launch.serve.run_static(mesh=, teacher=, keep=True)`: the prefill and
    teacher-forced decode steps, with the host-staged gathers they make
    and the collectives (`CommDebugMode`). A dict case names its arch,
    dtype, batch, lengths, weights file and the dry run's variant
    ('baseline', 'kvq8', 'seqkv', 'combo': `variant_config`; the cache
    split along its sequence for the last two). Then each of
    `args["moe_blocks"]` (`_moe_block`). Rank 0 writes every case's logits,
    the gathered cache and the param and cache specs to `mesh_serve.pkl`."""
    import argparse
    import dataclasses

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    torch.set_num_threads(2)
    a = spec["args"]
    mesh = make_emulated_mesh(tuple(a["mesh"]), device="cpu")
    teacher = np.load(os.path.join(spec["outdir"], "teacher.npy"))
    # the constraint's contract on plain tensors and DTensors
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    with rsh.activate(mesh, rsh.SERVE_RULES):
        placed = mnn.shard(x, "batch", None, "heads")
        odd = mnn.shard(x[:3, :, :6], "batch", None, "heads")
        same = mnn.shard(x, "batch", None) is x
        back = mnn.shard(placed, None, None, None)
        bound = mnn.shard_fn() is not None
    start, stop = rsh.local_box(rsh.NamedSharding(mesh, tuple(placed.placements)), (4, 6, 8))
    guard = dict(
        placed=_spec(placed), odd=_spec(odd), same=same, back=_spec(back), bound=bound,
        unbound=mnn.shard_fn() is None,
        box=bool(torch.equal(placed.to_local(), x[tuple(slice(i, j) for i, j in zip(start, stop))])),
        back_equal=bool(torch.equal(back.to_local(), x)),
    )
    out = {}
    for case in a["cases"]:
        if isinstance(case, dict):  # a cache variant: its own config, lengths and weights
            arch, dtype, batch = case["arch"], case["dtype"], case["batch"]
            weights = _case_weights(spec, case["weights"], arch)
            cfg = variant_config(arch, dtype, case["variant"], case.get("overrides"))
            prompt_len, gen, key = case["prompt_len"], case["gen"], case["name"]
            seq_shard = case["variant"] in ("seqkv", "combo")
        else:
            arch, dtype, batch = case if len(case) == 3 else (a["arch"], *case)
            weights = _case_weights(spec, "weights-{arch}.npz" if len(case) == 3
                                    else "weights.npz", arch)
            cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype=dtype)
            prompt_len, gen, key = a["prompt_len"], a["gen"], "/".join(str(c) for c in case)
            seq_shard = False
        model = build_model(cfg, device="cpu")
        desc = model.desc()
        lay = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rsh.SERVE_RULES, mesh,
                                            mnn.abstract_tree(desc)))
        params = nest({k: dist.put_global(torch.from_numpy(w), lay[k])
                             for k, w in weights.items()})
        args = argparse.Namespace(batch=batch, prompt_len=prompt_len, gen=gen, sample=False)
        with _GatherLog() as gathers, CommDebugMode() as comm:
            res = serve.run_static(args, cfg, model, params, mesh=mesh,
                                   teacher=teacher[:batch, : gen - 1], keep=True,
                                   seq_shard=seq_shard)
        cache = _flat(res["cache"])
        whole = {k: dist.gather(v) for k, v in cache.items()}
        forward = None
        if not isinstance(case, dict):
            # the forward without a cache (no bfloat16 K/V on the way), on
            # run_static's prompts and frontend inputs
            rng = np.random.default_rng(0)
            inputs = dict(tokens=rng.integers(1, cfg.vocab, (batch, prompt_len)).astype(np.int32),
                          **frontend_inputs(cfg, batch, rng))
            lay_in = batch_shardings(inputs, mesh, batch)
            with rsh.activate(mesh, rsh.SERVE_RULES):
                logits, _ = model.forward(params, {k: dist.put_global(torch.from_numpy(v),
                                                                      lay_in[k])
                                                   for k, v in inputs.items()})
            forward = dist.gather(logits).numpy()
        out[key] = dict(
            forward=forward, comm={str(k): v for k, v in comm.get_comm_counts().items()},
            logits=[t.numpy() for t in res["logits"]], tokens=res["tokens"],
            cache={k: v.to(torch.float32).numpy() for k, v in whole.items()},
            param_specs={k: _spec(v) for k, v in _flat(params).items()},
            cache_specs={k: _spec(v) for k, v in cache.items()}, gathers=gathers.seen,
        )
    blocks_out = {c["name"]: _moe_block(spec, mesh, c) for c in a.get("moe_blocks", [])}
    if rank == 0:
        _dump(spec, "mesh_serve.pkl", dict(out, moe_blocks=blocks_out) if blocks_out else out)
    return {"rank": rank, "backend": dist.backend(), "guard": guard,
            "tokens": {k: v["tokens"].tolist() for k, v in out.items()}}


def _gather_backward_check(mesh) -> dict:
    """The gradient through `sharding.redistribute`'s gather against the
    plain gradient's box, on this rank: a (7, 6) float64 tensor split
    unevenly over 'model' (chunks of 2, 2, 2, 1 on four ranks) gathered
    (1) under a replicated gradient, a weighted sum, and (2) as FSDP
    gathers a weight: its product with a (7, 7) input split by rows over
    'model' too gives each rank part of the weight's gradient, pending over
    'model', and each rank keeps its box of the sum (a reduce-scatter);
    and (3) a (10, 6) tensor split over both mesh dims along its rows."""
    import torch
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    gen = torch.Generator().manual_seed(11)
    w = torch.randn(7, 6, generator=gen, dtype=torch.float64)
    c = torch.randn(7, 6, generator=gen, dtype=torch.float64)
    x = torch.randn(7, 7, generator=gen, dtype=torch.float64)
    whole = tuple(Replicate() for _ in mesh.mesh.shape)
    split = _lay(mesh, ("model", None))
    out = {}
    # (1) a replicated gradient: each rank keeps its rows of c
    wd = dist.put_global(w, split).requires_grad_(True)
    y = rsh.redistribute(wd, whole)
    (g,) = torch.autograd.grad((y.to_local() * c).sum(), wd)
    start, stop = rsh.local_box(split, (7, 6))
    out["replicated"] = dict(
        placements=_spec(g), err=float((g.to_local() - c[start[0]:stop[0]]).abs().max()),
        rows=int(g.to_local().shape[0]))
    # (2) a pending gradient: x's rows split over 'model' too, so each rank's
    # product gives part of the weight's gradient
    xd = dist.put_global(x, split)
    wd = dist.put_global(w, split).requires_grad_(True)
    pending = tuple(Partial() if n == "model" else Replicate() for n in mesh.mesh_dim_names)
    prod = xd.to_local() @ rsh.redistribute(wd, whole).to_local(grad_placements=pending)
    (g,) = torch.autograd.grad((torch.tanh(prod) * prod).sum(), wd)
    wp = w.clone().requires_grad_(True)
    pp = x @ wp
    (gp,) = torch.autograd.grad((torch.tanh(pp) * pp).sum(), wp)
    out["pending"] = dict(
        placements=_spec(g), err=float((g.to_local() - gp[start[0]:stop[0]]).abs().max()),
        scale=float(gp.abs().max()))
    # (3) a dim split over both mesh dims (as TRAIN_RULES split the batch
    # over ('pod', 'data')): a (10, 6) tensor chunked over 'data', each
    # chunk over 'model' (uneven on both meshes), gathered whole, its
    # replicated gradient scattered back to each rank's box
    nested = _lay(mesh, (("data", "model"), None))
    w10, c10 = torch.cat([w, w[:3]]), torch.cat([c, c[:3]])
    wd = dist.put_global(w10, nested).requires_grad_(True)
    y = rsh.redistribute(wd, whole)
    (g,) = torch.autograd.grad((y.to_local() * c10).sum(), wd)
    start, stop = rsh.local_box(nested, (10, 6))
    out["nested"] = dict(placements=_spec(g), forward=float((y.to_local() - w10).abs().max()),
                         err=float((g.to_local() - c10[start[0]:stop[0]]).abs().max()))
    return out


def scenario_mesh_train(spec: dict, rank: int) -> dict:
    """The dense decoders' train step under a mesh of the job's ranks: for
    each (arch, rules, dtype) case, the reduced model's params (the job's
    `weights.npz`, laid out by `tree_shardings(rules)`) and the batches of
    `synthetic_batch` laid out by `batch_shardings`: the loss and every
    gradient of step 0 (`steps.loss_and_grads`, its collectives counted),
    then the chained train
    steps with gradient compression (`make_train_step`): each step's
    metrics and the params and Adam state after the last. Then the
    launcher (`launch.train.run(mesh=)`) with an async save and a resume,
    and `_gather_backward_check`. Rank 0 writes everything, gathered, to
    `mesh_train.pkl`."""
    import dataclasses

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime import dist, steps
    from repro_torch.runtime import sharding as rsh

    torch.set_num_threads(2)
    a = spec["args"]
    mesh = make_emulated_mesh(tuple(a["mesh"]), device="cpu")

    def host(tree) -> dict:
        return {k: dist.gather(v).to(torch.float32).numpy() for k, v in _flat(tree).items()}

    out = {}
    for arch, rules_name, dtype in a["cases"]:
        weights = _case_weights(spec, a.get("weights_file", "weights.npz"), arch)
        rules = getattr(rsh, rules_name)
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), n_layers=a["layers"],
                                  dtype=dtype)
        model = build_model(cfg, device="cpu")
        desc = model.desc()
        lay = _flat(rsh.tree_shardings(mnn.axes_tree(desc), rules, mesh, mnn.abstract_tree(desc)))
        params = nest({k: dist.put_global(torch.from_numpy(w), lay[k]) for k, w in weights.items()})
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=a["seq"], global_batch=a["batch"])
        batches = []
        for s in range(a["steps"]):
            b = train_batch(cfg, dcfg, s)
            blay = batch_shardings(b, mesh, a["batch"])
            batches.append({k: dist.put_global(torch.from_numpy(v), blay[k]) for k, v in b.items()})
        with rsh.activate(mesh, rules):
            with CommDebugMode() as comm:
                grads, aux = steps.loss_and_grads(model, params, batches[0])
            gc = GradCompressConfig(eb_rel=a["eb_rel"])
            step = steps.make_train_step(model, AdamWConfig(**a["opt"]), gc)
            opt = steps.init_opt_state(params, gc)
            metrics = []
            for b in batches:
                params, opt, m = step(params, opt, b)
                metrics.append({k: float(v) for k, v in m.items()})
        out[f"{arch}/{rules_name}/{dtype}"] = dict(
            loss=float(aux["loss"]), tokens=float(aux["tokens"]), grads=host(grads),
            comm={str(k): v for k, v in comm.get_comm_counts().items()},
            grad_specs={k: _spec(v) for k, v in _flat(grads).items()}, metrics=metrics,
            params=host(params), m=host(opt["adam"]["m"]), v=host(opt["adam"]["v"]),
            specs={f"{part}/{k}": _spec(v) for part, tree in (
                ("params", params), ("m", opt["adam"]["m"]), ("v", opt["adam"]["v"]),
                ("residual", opt["gc"]["residual"])) for k, v in _flat(tree).items()},
            step=int(opt["adam"]["step"]))
    # the launcher on the mesh (where asked): an async save at step 2, the
    # final save, a resume to the last step
    launcher = dict(losses=[], resumed=[])
    la = a.get("launcher")
    if la:
        ckpt = os.path.join(spec["outdir"], "ckpt")
        args = train.parse_args(la["argv"] + ["--ckpt-dir", ckpt])
        cfg, model = train.build(args)
        rules = getattr(rsh, la.get("rules", "TRAIN_RULES"))
        first = train.run(args, cfg, model, rsh.place_params(model, mesh, rules), mesh=mesh,
                          rules=rules)
        args = train.parse_args(la["argv"] + ["--ckpt-dir", ckpt, "--steps",
                                              str(la["resume_steps"]), "--resume"])
        again = train.run(args, cfg, model, rsh.place_params(model, mesh, rules), mesh=mesh,
                          rules=rules)
        launcher = dict(losses=first["losses"], resumed=again["losses"],
                        params_specs={k: _spec(v) for k, v in _flat(again["params"]).items()},
                        params=host(again["params"]))
    check = _gather_backward_check(mesh)
    if rank == 0:
        _dump(spec, "mesh_train.pkl", dict(cases=out, launcher=launcher))
    return {"rank": rank, "backend": dist.backend(), "gather_backward": check,
            "losses": {k: [m["loss"] for m in v["metrics"]] for k, v in out.items()},
            "launcher": launcher["losses"] + launcher["resumed"]}


def scenario_mesh_moe(spec: dict, rank: int) -> dict:
    """`scenario_mesh_serve` with `args["serve"]`, then `scenario_mesh_train`
    with `args["train"]`, in the same ranks: one payload with both."""
    a = spec["args"]
    served = scenario_mesh_serve(dict(spec, args=a["serve"]), rank)
    trained = scenario_mesh_train(dict(spec, args=a["train"]), rank)
    return dict(trained, tokens=served["tokens"], guard=served["guard"])


def scenario_mesh_families(spec: dict, rank: int) -> dict:
    """`scenario_mesh_moe` for the vision frontend, the encoder-decoder,
    the hybrid and xLSTM, plus each family's cache under a mesh as
    `init_cache` lays it out (`args["init_cache"]`: (arch, batch,
    max_len) cases: every leaf a DTensor, its spec)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.models import build_model, reduced_for_smoke
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import sharding as rsh

    # the reference compiles in the test's process meanwhile: the ranks
    # take the cycles it leaves
    os.nice(10)
    out = scenario_mesh_moe(spec, rank)
    a = spec["args"]
    mesh = make_emulated_mesh(tuple(a["serve"]["mesh"]), device="cpu")
    caches = {}
    for arch, batch, max_len in a.get("init_cache", []):
        model = build_model(reduced_for_smoke(get_config(arch)), device="cpu")
        with rsh.activate(mesh, rsh.SERVE_RULES):
            cache = _flat(model.init_cache(batch, max_len))
        caches[arch] = {k: (_spec(v) if mnn.is_sharded(v) else None) for k, v in cache.items()}
    return dict(out, init_cache=caches)


def card_config(arch: str):
    """The config a card test runs `arch` at: phi4-mini-3.8b at full width
    and one layer; smollm-360m at full width and 2 layers, float32;
    deepseek-v2-236b at a reduced width (d_model 1024, 16 heads, MLA latent
    256, top-6 of 16 experts and 2 shared ones) and 2 layers, its leading
    dense layer and one MoE layer, float32 (the routing then agrees with
    the unsharded run's, as tests/test_torch_moe.py explains); zamba2-1.2b
    and xlstm-1.3b at their `reduced_for_smoke` sizes, float32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke
    from repro_torch.models.config import MLACfg

    cfg = get_config(arch)
    if arch in ("zamba2-1.2b", "xlstm-1.3b"):
        return reduced_for_smoke(cfg).scaled(dtype="float32")
    if arch == "phi4-mini-3.8b":
        return cfg.scaled(n_layers=1)
    if arch == "smollm-360m":
        return cfg.scaled(n_layers=2, dtype="float32")
    return cfg.scaled(
        n_layers=2, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816, vocab=8192,
        dtype="float32", mla=MLACfg(q_lora=512, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64),
        moe=dataclasses.replace(cfg.moe, n_experts=16, d_ff_expert=512, d_ff_shared=1024))


def scenario_card_layer(spec: dict, rank: int) -> dict:
    """Two ranks on one card over gloo, on the ('data', 'model') mesh of
    `args["mesh"]` (default (1, 2)): one decoder layer of `args["arch"]`
    (`card_config`; default phi4-mini-3.8b: attention with its cache, SwiGLU
    MLP; deepseek-v2-236b: MLA with its latent cache, the MoE) under
    `activate(mesh, SERVE_RULES)`, a 16-token prefill and one decode step,
    against the same layer run unsharded on the card from the same weights:
    each output's and the cache's distance, of their max."""
    import torch

    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.models import blocks, build_model
    from repro_torch.models import nn as mnn
    from repro_torch.runtime import dist
    from repro_torch.runtime import sharding as rsh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    a = spec.get("args") or {}
    mesh = make_emulated_mesh(tuple(a.get("mesh", (1, 2))))
    cfg = card_config(a.get("arch", "phi4-mini-3.8b"))
    model = build_model(cfg, device=dev)
    if cfg.moe:
        desc = {"attn": model._attn_desc(), "mlp": blocks.desc_moe(cfg)}
    else:
        desc = {"attn": blocks.desc_attn(cfg), "mlp": blocks.desc_mlp(cfg)}
    full = mnn.init_tree(desc, torch.Generator(device=dev).manual_seed(0), device=dev)
    lay = rsh.tree_shardings(mnn.axes_tree(desc), rsh.SERVE_RULES, mesh, mnn.abstract_tree(desc))
    params = mnn.tree_map(dist.put_global, full, lay)
    gen = torch.Generator(device=dev).manual_seed(1)
    b, l = 2, 16
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    xs = torch.randn(b, l + 1, cfg.d_model, generator=gen, device=dev).to(dt)
    outs, caches = {}, {}
    for name, p in (("plain", full), ("sharded", params)):
        with rsh.activate(mesh, rsh.SERVE_RULES) if name == "sharded" else _nothing():
            cache = mnn.layer(model.init_cache(b, l + 1)["blocks"], 0)
            x = mnn.shard(xs, "batch", None, None)
            got = []
            for lo, hi in ((0, l), (l, l + 1)):
                positions = torch.arange(lo, hi, device=dev)[None]
                cl = dict(cache, len=torch.tensor(lo, dtype=torch.int32, device=dev))
                y, _ = model._block(p, x[:, lo:hi], positions, cl)
                got.append(dist.gather(y) if name == "sharded" else y.cpu())
            outs[name] = got
            caches[name] = {k: dist.gather(v) if name == "sharded" else v.cpu()
                            for k, v in cache.items()}
            if name == "sharded":
                caches["sharded_specs"] = dict(cache)

    def rel(a, w):
        a, w = a.to(torch.float32), w.to(torch.float32)
        return float((a - w).abs().max() / w.abs().max())

    return dict(
        rank=rank, backend=dist.backend(), device=str(params["attn"]["norm"].to_local().device),
        specs={k: _spec(v) for k, v in _flat(params).items()},
        cache_specs={k: _spec(v) for k, v in caches["sharded_specs"].items()},
        prefill=rel(outs["sharded"][0], outs["plain"][0]),
        decode=rel(outs["sharded"][1], outs["plain"][1]),
        cache={k: rel(caches["sharded"][k], caches["plain"][k]) for k in caches["plain"]},
    )



def scenario_card_train(spec: dict, rank: int) -> dict:
    """Two ranks on one card over gloo, on the ('data', 'model') mesh of
    `args["mesh"]`: `args["arch"]` at its `card_config` (default
    smollm-360m at full width and 2 layers, float32) under
    `activate(mesh, rules)` (`args["rules"]`, default `TRAIN_RULES`), one
    batch of 4 x 64 tokens. For
    smollm-360m on (1, 2), 15 query and 5 KV heads: `split_heads` gathers
    Q, K and V, the vocab is split over 'model'; on (2, 1), FSDP: the batch
    split over 'data', each weight's 'embed' dim gathered before its
    product and its gradient reduce-scattered. deepseek-v2-236b adds MLA's
    heads and the experts over 'model', and the MoE routing over the batch
    split. The loss and gradients (`steps.loss_and_grads`) and one train
    step with gradient compression, against the same on the unsharded
    params on the card. Each quantity's distance, of its max."""
    import torch

    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.dryrun import batch_shardings
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.models import build_model
    from repro_torch.models import nn as mnn
    from repro_torch.optim import AdamWConfig, GradCompressConfig
    from repro_torch.runtime import dist, steps
    from repro_torch.runtime import sharding as rsh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_emulated_mesh(tuple(spec["args"]["mesh"]))
    cfg = card_config(spec["args"].get("arch", "smollm-360m"))
    rules = getattr(rsh, spec["args"].get("rules", "TRAIN_RULES"))
    model = build_model(cfg, device=dev)
    desc = model.desc()
    full = mnn.init_tree(desc, torch.Generator(device=dev).manual_seed(0), device=dev)
    lay = rsh.tree_shardings(mnn.axes_tree(desc), rules, mesh, mnn.abstract_tree(desc))
    params = mnn.tree_map(dist.put_global, full, lay)
    plain = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4), 0)
    blay = batch_shardings(plain, mesh, 4)
    plain = {k: torch.from_numpy(v).to(dev) for k, v in plain.items()}
    batch = {k: dist.put_global(v, blay[k]) for k, v in plain.items()}
    gc = GradCompressConfig(eb_rel=1e-3)
    step = steps.make_train_step(model, AdamWConfig(lr=1e-3, total_steps=100, warmup_steps=5), gc)
    with rsh.activate(mesh, rules):
        grads, aux = steps.loss_and_grads(model, params, batch)
        grads = {k: dist.gather(v) for k, v in _flat(grads).items()}
        params, _, metrics = step(params, steps.init_opt_state(params, gc), batch)
    want_grads, want_aux = steps.loss_and_grads(model, full, plain)
    full, _, want = step(full, steps.init_opt_state(full, gc), plain)

    def rel(a, w):
        a, w = a.to(torch.float32).cpu(), w.to(torch.float32).cpu()
        return float((a - w).abs().max() / w.abs().max())

    moved = {k: dist.gather(v) for k, v in _flat(params).items()}
    return dict(
        rank=rank, backend=dist.backend(), device=str(params["embed"].to_local().device),
        specs={k: _spec(v) for k, v in _flat(params).items()},
        loss=rel(aux["loss"], want_aux["loss"]),
        grads={k: rel(g, _flat(want_grads)[k]) for k, g in grads.items()},
        metrics={k: rel(metrics[k], want[k]) for k in ("grad_norm", "wire_bits_per_value")},
        # after one step: the share of values off by more than 1e-5 of the
        # leaf's max, and the largest distance over the step's lr
        params={k: [float(((v - w.cpu()).abs() > 1e-5 * w.abs().max().cpu()).float().mean()),
                    float((v - w.cpu()).abs().max() / want["lr"].cpu())]
                for k, (v, w) in ((k, (moved[k], x)) for k, x in _flat(full).items())},
    )


def _nothing():
    import contextlib

    return contextlib.nullcontext()


def scenario_dryrun(spec: dict, rank: int) -> dict:
    """The dry-run launcher in this one process (the fake group is global to
    it, so the job's one-rank gloo group is left first): each of
    `args["cells"]` (name, arch, shape, variant, mesh shape) lowered at
    full width and one layer unit (`lower_cell(units=1)`) on fake tensors
    over a fake group of the mesh's size, its counts; then `analyze_cell`
    of `args["record"]` (arch, shape, variant) on a fake (2, 2) group with
    the config cut to `args["record_layers"]` layers (a uniform stack:
    its `corrected` extrapolation must give its own counts), and of
    `args["skip"]` (a full-attention arch at long_500k)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_emulated_mesh
    from repro_torch.runtime import dist

    torch.set_num_threads(2)
    dist.shutdown()
    a = spec["args"]
    out: dict = {"cells": {}}
    for name, arch, shape, variant, mesh_shape in a["cells"]:
        names = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
        with dryrun.fake_group(math.prod(mesh_shape)):
            mesh = make_emulated_mesh(tuple(mesh_shape), names, device="cpu")
            c, _ = dryrun.lower_cell(arch, shape, mesh, units=1, variant=variant)
        out["cells"][name] = dict(
            flops=c.flops, bytes=c.bytes_accessed, collectives=c.collectives,
            counts=c.collective_counts, seconds=c.seconds,
            memory=dict(argument=c.memory.argument_size_in_bytes,
                        output=c.memory.output_size_in_bytes,
                        alias=c.memory.alias_size_in_bytes, temp=c.memory.temp_size_in_bytes))
    arch, shape, variant = a["record"]
    full = dryrun.get_config
    dryrun.get_config = lambda name: full(name).scaled(n_layers=a["record_layers"])
    try:
        with dryrun.fake_group(4):
            mesh = make_emulated_mesh((2, 2), device="cpu")
            out["record"] = dryrun.analyze_cell(arch, shape, "single", variant=variant,
                                                mesh=mesh)
            out["skip"] = dryrun.analyze_cell(a["skip"], "long_500k", "single", mesh=mesh)
    finally:
        dryrun.get_config = full
    out["record_units"] = dryrun.full_units(get_config(arch).scaled(n_layers=a["record_layers"]))
    return out


SCENARIOS = {
    "card": scenario_card,
    "card_layer": scenario_card_layer,
    "card_train": scenario_card_train,
    "dryrun": scenario_dryrun,
    "mesh_families": scenario_mesh_families,
    "mesh_moe": scenario_mesh_moe,
    "mesh_serve": scenario_mesh_serve,
    "mesh_train": scenario_mesh_train,
    "fault": scenario_fault,
    "owner": scenario_owner,
    "save_restore": scenario_save_restore,
    "sharded": scenario_sharded,
}


if __name__ == "__main__":
    from repro_torch.launch import mhrun

    sys.exit(mhrun.worker_main(sys.argv[-1], SCENARIOS))
