"""Logical-axis layout rules and shard-layout introspection, on DTensors.

Port of the layout half of `repro.runtime.sharding`. Model code names the
logical axes of every parameter (`models/nn.py` `P.axes`); a rules table
maps them onto the named dims of a `DeviceMesh` per mode, so swapping
rules swaps the parallelism layout without touching model code. Default
layout (DESIGN.md §6), mesh ('pod', 'data', 'model'):

* DP over pod x data (batch);
* TP over model (heads / mlp / experts / vocab);
* FSDP: weight 'embed' dims sharded over data.

A layout is a spec: one entry per tensor dim, a mesh dim name, a tuple of
names, or None (the reference's `PartitionSpec`). `NamedSharding(mesh,
placements)` is its torch form: ``Shard(d)`` for a mesh dim that splits
tensor dim d, ``Replicate()`` for one that splits nothing.

The introspection half (`mesh_of`, `spec_entries`, `unique_shards`,
`shard_data`, `local_box`) tells the shard-local engine (`core/sharded.py`)
and the segment writer where a DTensor's bytes live without gathering
them. One rank is one device: a replica group is a tuple of ranks.

Compute under a mesh (`activate`, `cache_sharding`) is ROADMAP item 14b.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

TRAIN_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "embed": "data",      # FSDP axis for weights
    "heads": "model",
    "mlp": "model",
    "experts": "model",
    "kv": "model",
    "layers": None,
    "norm": None,
}

#: weights TP-only (no FSDP split of the weights' embed dims)
TRAIN_RULES_TP: dict[str, Any] = dict(TRAIN_RULES, embed=None)

#: no FSDP split on the decode path
SERVE_RULES: dict[str, Any] = dict(TRAIN_RULES, embed=None)


@dataclass(frozen=True)
class NamedSharding:
    """A DTensor layout: a mesh with named dims and one placement per mesh
    dim (the reference's `NamedSharding(mesh, PartitionSpec)`)."""

    mesh: Any
    placements: tuple

    @property
    def spec(self) -> tuple:
        return placements_to_spec(self.mesh, self.placements, None)


def _names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim called `name`."""
    return int(mesh.mesh.shape[_names(mesh).index(name)])


def mesh_shape(mesh) -> dict[str, int]:
    return {n: int(s) for n, s in zip(_names(mesh), mesh.mesh.shape)}


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on under `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def spec_for_axes(axes: tuple, rules: dict, mesh) -> tuple:
    """Resolve logical axes to a spec, dropping mesh dims the mesh lacks and
    never using one mesh dim twice in a single spec."""
    names = set(_names(mesh))
    used: set[str] = set()
    parts = []
    for ax in axes:
        rule = rules.get(ax) if ax is not None else None
        if rule is None:
            parts.append(None)
            continue
        cand = (rule,) if isinstance(rule, str) else tuple(rule)
        cand = tuple(a for a in cand if a in names and a not in used)
        if not cand:
            parts.append(None)
        else:
            used.update(cand)
            parts.append(cand[0] if len(cand) == 1 else cand)
    return tuple(parts)


def spec_to_placements(mesh, spec: tuple) -> tuple:
    """A spec's placements on `mesh`: ``Shard(d)`` for each mesh dim named
    at tensor dim d, ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in _names(mesh))


def placements_to_spec(mesh, placements, ndim: int | None) -> tuple:
    """The spec of `placements`: per tensor dim, None, one mesh dim name, or
    a tuple of names in mesh-dim order (padded with None to `ndim`)."""
    from torch.distributed.tensor import Shard

    per_dim: dict[int, list[str]] = {}
    for name, p in zip(_names(mesh), placements):
        if isinstance(p, Shard):
            per_dim.setdefault(int(p.dim), []).append(name)
    n = ndim if ndim is not None else (max(per_dim) + 1 if per_dim else 0)
    return tuple(
        None if d not in per_dim else per_dim[d][0] if len(per_dim[d]) == 1 else tuple(per_dim[d])
        for d in range(n)
    )


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not _is_axes(tree):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_specs(axes_tree: Any, rules: dict, mesh) -> Any:
    return _tree_map(lambda axes: spec_for_axes(axes, rules, mesh), axes_tree)


def tree_shardings(axes_tree: Any, rules: dict, mesh, abstract: Any = None) -> Any:
    """`NamedSharding`s for a logical-axes tree. With `abstract` (the
    matching tree of shapes, `nn.abstract_tree`), mesh dims that do not
    divide a dim are dropped, so every shard is even."""
    specs = tree_specs(axes_tree, rules, mesh)
    if abstract is None:
        return _tree_map(lambda spec: NamedSharding(mesh, spec_to_placements(mesh, spec)), specs)
    sizes = mesh_shape(mesh)

    def _fit(spec: tuple, leaf) -> NamedSharding:
        parts = []
        for i, d in enumerate(leaf.shape):
            p = spec[i] if i < len(spec) else None
            if p is None:
                parts.append(None)
                continue
            names = (p,) if isinstance(p, str) else tuple(p)
            n = math.prod(sizes[a] for a in names)
            parts.append(p if d % n == 0 else None)
        return NamedSharding(mesh, spec_to_placements(mesh, tuple(parts)))

    return _tree_map(_fit, specs, abstract)


def activate(mesh, rules: dict):
    raise NotImplementedError(
        "activation constraints under a mesh (nn.shard) are ROADMAP.md queue A, item 14b"
    )


def cache_sharding(*args, **kwargs):
    raise NotImplementedError("cache_sharding is ROADMAP.md queue A, item 14b")


# ---------------------------------------------------------------------------
# Shard-layout introspection (DESIGN.md §6)
# ---------------------------------------------------------------------------


def mesh_of(x: Any):
    """The DeviceMesh behind a DTensor `x` whose placements are all Shard or
    Replicate, or None (host arrays, plain tensors, pending reductions):
    callers take the gather path."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return None
    if not all(isinstance(p, (Shard, Replicate)) for p in x.placements):
        return None
    return x.device_mesh


def spec_entries(x: Any) -> tuple:
    """`x`'s spec, one entry per dim."""
    return placements_to_spec(x.device_mesh, x.placements, x.ndim)


def _coords(mesh) -> dict[int, tuple[int, ...]]:
    ranks = mesh.mesh.cpu().numpy()
    return {int(r): tuple(int(c) for c in idx) for idx, r in np.ndenumerate(ranks)}


def rank_at(mesh, coords: tuple[int, ...]) -> int:
    return int(mesh.mesh[tuple(coords)])


def neighbors(mesh, name: str, rank: int) -> tuple[int | None, int | None]:
    """(previous, next) rank of `rank` along the mesh dim `name` (None past
    either end)."""
    ax = _names(mesh).index(name)
    c = list(_coords(mesh)[rank])
    n = int(mesh.mesh.shape[ax])
    prev = nxt = None
    if c[ax] > 0:
        prev = rank_at(mesh, tuple(c[:ax] + [c[ax] - 1] + c[ax + 1 :]))
    if c[ax] < n - 1:
        nxt = rank_at(mesh, tuple(c[:ax] + [c[ax] + 1] + c[ax + 1 :]))
    return prev, nxt


def shard_box(mesh, placements, shape: tuple[int, ...], rank: int) -> tuple[tuple, tuple]:
    """(start, stop) of `rank`'s shard of a tensor of `shape`: each Shard
    placement, in mesh-dim order, splits the current extent of its dim into
    ceil-sized chunks (torch's chunking; the last ones may be short)."""
    from torch.distributed.tensor import Shard

    coords = _coords(mesh)[rank]
    start = [0] * len(shape)
    stop = [int(s) for s in shape]
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = int(p.dim) % max(len(shape), 1)
        n = int(mesh.mesh.shape[i])
        extent = stop[d] - start[d]
        chunk = -(-extent // n)
        a = start[d] + min(coords[i] * chunk, extent)
        b = start[d] + min((coords[i] + 1) * chunk, extent)
        start[d], stop[d] = a, b
    return tuple(start), tuple(stop)


def local_box(sharding: NamedSharding, shape: tuple[int, ...]) -> tuple[tuple, tuple]:
    """This process's box of a tensor of `shape` under `sharding`."""
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    return shard_box(sharding.mesh, sharding.placements, shape, rank)


def unique_shards(x: Any) -> list[tuple[tuple[int, ...], tuple[int, ...], tuple[int, ...]]]:
    """[(start, stop, replica_ranks)]: one entry per *unique* data shard of a
    DTensor `x`, in row-major shard order, the ranks holding each replica
    in ascending order. Reading one replica of each entry touches every
    byte exactly once."""
    shape = tuple(int(s) for s in x.shape)
    mesh = x.device_mesh
    by_box: dict[tuple, list[int]] = {}
    for rank in _coords(mesh):
        st, sp = shard_box(mesh, x.placements, shape, rank)
        by_box.setdefault(tuple(zip(st, sp)), []).append(rank)
    return [
        (tuple(k[0] for k in key), tuple(k[1] for k in key), tuple(sorted(by_box[key])))
        for key in sorted(by_box)
    ]


def shard_data(x: Any, rank: int) -> torch.Tensor:
    """`x`'s shard held by `rank`, which must be this process (no gather)."""
    me = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if int(rank) != me:
        raise ValueError(f"rank {rank} is not this process (rank {me}): its shard is remote")
    return x.to_local()


__all__ = [
    "NamedSharding",
    "SERVE_RULES",
    "TRAIN_RULES",
    "TRAIN_RULES_TP",
    "activate",
    "axis_size",
    "cache_sharding",
    "local_box",
    "mesh_device",
    "mesh_of",
    "mesh_shape",
    "neighbors",
    "placements_to_spec",
    "shard_box",
    "shard_data",
    "spec_entries",
    "spec_for_axes",
    "spec_to_placements",
    "tree_shardings",
    "tree_specs",
    "unique_shards",
]
