"""Sharded-checkpoint dryrun (DESIGN.md §6, §6.2), on `torch.distributed`.

Port of `repro.launch.shardckpt`. It synthesizes a train-state-like tree
of DTensors (FSDP-style weights over 'data', TP-style over 'model', a
replicated norm, raw optimizer moments, an int step) and runs the whole
shard-local pipeline:

  1. `CheckpointManager(sharded=True).save`: decisions from per-shard
     statistics (no gather), per-shard segments, per-host data files;
  2. an elastic restore under a DIFFERENT mesh shape through
     `restore_tree(shardings=...)`;
  3. parity against the flat (gathered) writer: the same codec decisions
     and the same decoded values.

One process is one rank. Without ``--processes`` the job is one rank on a
(1, 1) mesh; ``--processes N`` (2 or 4) starts N ranks through
`launch/mhrun.py` on a (2, N/2) mesh and restores under (N, 1):

    PYTHONPATH=src python -m repro_torch.launch.shardckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.shardckpt --processes 4 --device cpu

It prints ``dryrun OK`` / ``multi-host dryrun OK`` when there are no value
mismatches and no decision flips, and exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch


def synth_state(mesh, n_fields: int, dim: int, seed: int = 0):
    """(tree, shardings): weights over 'data' or 'model' (alternating), Adam
    moments laid out like them, a replicated norm and a host int32 step.
    Every rank draws the same values from `seed` and keeps its own shards
    (`dist.put_global`)."""
    from ..runtime import dist
    from ..runtime import sharding as rsh

    def lay(spec):
        return rsh.NamedSharding(mesh, rsh.spec_to_placements(mesh, spec))

    rng = np.random.default_rng(seed)
    tree: dict = {"params": {}, "opt": {}}
    shardings: dict = {"params": {}, "opt": {}}
    for i in range(n_fields):
        name = f"layer{i:02d}/w"
        s = lay(("data", None) if i % 2 == 0 else (None, "model"))
        x = np.cumsum(rng.standard_normal((dim, dim)), axis=0).astype(np.float32)
        m = (0.01 * rng.standard_normal((dim, dim))).astype(np.float32)
        tree["params"][name], shardings["params"][name] = dist.put_global(x, s), s
        tree["opt"][name], shardings["opt"][name] = dist.put_global(m, s), s
    s = lay((None,))
    tree["params"]["norm"] = dist.put_global(np.linspace(0.9, 1.1, dim, dtype=np.float32), s)
    shardings["params"]["norm"] = s
    tree["step"] = np.array(1234, np.int32)
    shardings["step"] = None
    return tree, shardings


def _leaves(tree) -> dict:
    from ..core import pytree

    return {pytree.leaf_name(p): v for p, v in pytree.flatten_with_path(tree)[0]}


def dryrun(mesh, mesh2, args, directory: str) -> dict:
    """The pipeline on `mesh` (every rank of the job calls it): sharded save,
    restore under `mesh2`, parity with the flat writer. Returns this rank's
    report."""
    from ..checkpoint import CheckpointConfig, CheckpointManager
    from ..core import Policy
    from ..runtime import dist

    pol = Policy.fixed_accuracy(eb_rel=args.eb_rel)
    tree, _ = synth_state(mesh, args.fields, args.dim)
    msh = CheckpointManager(
        CheckpointConfig(os.path.join(directory, "sharded"), policy=pol, sharded=True,
                         barrier_timeout_s=60.0),
        device=args.device,
    )
    t0 = time.perf_counter()
    path = msh.save(1, tree)
    t_save = time.perf_counter() - t0
    host = dist.process_index()
    own_bytes = os.path.getsize(os.path.join(path, f"data.{host}.bin"))
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    _, shardings2 = synth_state(mesh2, args.fields, args.dim)
    t0 = time.perf_counter()
    _, restored = msh.restore_tree(tree, shardings=shardings2)
    t_restore = time.perf_counter() - t0
    stats = msh.last_restore_stats
    resharded = restored["params"]["layer00/w"].device_mesh is mesh2
    # the flat writer gathers the tree (a collective), host 0 writes, all
    # restore
    mun = CheckpointManager(
        CheckpointConfig(os.path.join(directory, "flat"), policy=pol, barrier_timeout_s=60.0),
        device=args.device,
    )
    mun.save(1, tree)
    with open(os.path.join(directory, "flat", f"step_{1:09d}", "manifest.json")) as f:
        bits_un = json.load(f)["selection_bits"]
    _, f_un = mun.restore()
    got = {k: dist.gather(v) for k, v in _leaves(restored).items()}
    mism = [k for k in f_un if not torch.equal(f_un[k].cpu(), got[k].cpu().reshape(f_un[k].shape))]
    flips = [k for k in bits_un if bits_un[k] != man["selection_bits"].get(k)]
    return dict(
        host=host, processes=dist.process_count(), save_seconds=t_save,
        restore_seconds=t_restore, own_bytes=int(own_bytes), total_bytes=int(man["total_bytes"]),
        raw_bytes=int(man["raw_bytes"]), fields=len(man["fields"]),
        segments=sum(len(fl["segments"]) for fl in man["fields"]), restore_stats=stats,
        resharded=bool(resharded), mismatches=mism, flips=flips,
    )


def _mh_dryrun(spec: dict, pid: int) -> dict:
    """Worker body of `--processes N`: the dryrun on a (2, N/2) mesh,
    restored under (N, 1)."""
    from .mesh import make_emulated_mesh

    a = argparse.Namespace(**spec["args"])
    n = int(spec["num_processes"])
    mesh = make_emulated_mesh((2, n // 2), device=a.device)
    mesh2 = make_emulated_mesh((n, 1), device=a.device)
    return dryrun(mesh, mesh2, a, a.directory)


def _report(p: dict) -> str:
    st = p["restore_stats"] or {}
    return (
        f"host {p['host']}/{p['processes']}: wrote {p['own_bytes'] / 1e6:.2f} MB of "
        f"{p['total_bytes'] / 1e6:.2f} MB ({p['raw_bytes'] / max(p['total_bytes'], 1):.2f}x, "
        f"{p['fields']} fields / {p['segments']} segments); save {p['save_seconds']:.2f}s, "
        f"restore {p['restore_seconds']:.2f}s decoding {st.get('segments_decoded')}/"
        f"{st.get('segments_total')} segments from hosts {st.get('hosts_opened')}; "
        f"resharded={p['resharded']}; {len(p['mismatches'])} value mismatches, "
        f"{len(p['flips'])} decision flips"
    )


def main(argv=None) -> int:
    if "--mh-worker" in sys.argv:
        from . import mhrun

        return mhrun.worker_main(sys.argv[-1], {"dryrun": _mh_dryrun})
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fields", type=int, default=8)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--eb-rel", type=float, default=1e-3)
    ap.add_argument("--processes", type=int, default=1, choices=(1, 2, 4))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu, or the GPU by default")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    from . import mhrun

    with tempfile.TemporaryDirectory() as wd:
        if args.processes > 1:
            results = mhrun.run(
                [sys.executable, "-m", "repro_torch.launch.shardckpt", "--mh-worker"],
                args.processes, scenario="dryrun", backend=args.backend,
                args=dict(vars(args), directory=os.path.join(wd, "ckpt")),
                timeout_s=args.timeout, workdir=os.path.join(wd, "mhrun"),
                build_kernels=args.device != "cpu",
            )
            payloads = mhrun.require_success(results)
        else:
            from ..runtime import dist
            from .mesh import make_emulated_mesh

            dist.initialize(args.backend, master_port=0, rank=0, world_size=1)
            try:
                mesh = make_emulated_mesh((1, 1), device=args.device)
                payloads = [dryrun(mesh, mesh, args, wd)]
            finally:
                dist.shutdown()
        for p in payloads:
            print(_report(p))
        if any(p["mismatches"] or p["flips"] or not p["resharded"] for p in payloads):
            print("DRYRUN FAILURE: value mismatches, decision flips or no reshard")
            return 1
    print("multi-host dryrun OK" if args.processes > 1 else "dryrun OK",
          f"({args.processes} process{'es' if args.processes > 1 else ''}, {args.backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
