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

Compute under a mesh: `activate(mesh, rules)` binds the activation
constraint behind `models.nn.shard` (a DTensor is redistributed to the
layout its logical axes resolve to, a plain tensor is taken as the global
value and each rank keeps its box), and `cache_sharding` lays out decode
caches by size matching, as the reference does.

The introspection half (`mesh_of`, `spec_entries`, `unique_shards`,
`shard_data`, `local_box`) tells the shard-local engine (`core/sharded.py`)
and the segment writer where a DTensor's bytes live without gathering
them. One rank is one device: a replica group is a tuple of ranks.
"""

from __future__ import annotations

import contextlib
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


#: id(mesh) -> (mesh, shape, {rank: coords}, {coords: rank})
_MESHES: dict[int, tuple] = {}


def _layout_of_mesh(mesh) -> tuple:
    """(shape, {rank: coords}, {coords: rank}) of `mesh`, read once a mesh
    from its rank tensor with every dispatch mode off (a dry run traces
    under `FakeTensorMode`, which would turn the tensor DeviceMesh builds
    for `mesh.mesh` into a fake one)."""
    hit = _MESHES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():
            t = mesh.mesh
            shape, flat = tuple(int(s) for s in t.shape), t.reshape(-1).tolist()
        ranks = np.array(flat, dtype=np.int64).reshape(shape)
        by_rank = {int(r): tuple(int(c) for c in idx) for idx, r in np.ndenumerate(ranks)}
        hit = _MESHES[id(mesh)] = (mesh, shape, by_rank, {c: r for r, c in by_rank.items()})
    return hit[1:]


def axis_size(mesh, name: str) -> int:
    """The size of the mesh dim called `name`."""
    return _layout_of_mesh(mesh)[0][_names(mesh).index(name)]


def mesh_shape(mesh) -> dict[str, int]:
    return dict(zip(_names(mesh), _layout_of_mesh(mesh)[0]))


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


def place_params(model, mesh, rules: dict) -> dict:
    """The params of `model` from a generator seeded 0 on the model's
    device, each leaf drawn whole in `init_tree`'s order and kept as this
    rank's box of its `tree_shardings(rules)` layout: the unsharded draw's
    values, laid out on `mesh`."""
    from ..models import nn

    desc = model.desc()
    shardings = tree_shardings(nn.axes_tree(desc), rules, mesh, nn.abstract_tree(desc))
    gen = torch.Generator(device=model.device).manual_seed(0)
    return nn.init_tree(desc, gen, device=model.device, shardings=shardings)


def cache_sharding(
    cache_desc: Any,
    mesh,
    batch: int,
    head_sizes: set[int] = frozenset(),
    seq_shard: bool = False,
) -> Any:
    """KV/state caches: shard the batch dim over (pod, data) and any
    head-bearing dim over model, identified by size matching.

    Finds the first dim equal to `batch` (sharded DP if divisible) and the
    first later dim whose size is in `head_sizes` and divisible by the model
    dim (sharded 'model'). Leading layer-stack dims stay replicated, unless
    the stack is as long as the batch: then the stack is the first dim of
    that size and takes the DP split (the reference's rule, kept as it is;
    `ROADMAP.md` §C).

    seq_shard: when no head dim can take the model dim, shard the first dim
    after the batch that is at least 128 x model long and divisible by it
    (the sequence) over 'model' instead.
    """
    names = _names(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    sizes = mesh_shape(mesh)
    dp_n = math.prod(sizes[a] for a in dp) if dp else 1
    model_n = sizes.get("model", 1)
    dp_spec = dp[0] if len(dp) == 1 else dp

    def _spec(leaf) -> tuple:
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        bdim = None
        for i, s in enumerate(shape):
            if s == batch:
                bdim = i
                if batch % dp_n == 0:
                    parts[i] = dp_spec
                break
        if bdim is not None:
            placed = False
            for j in range(bdim + 1, len(shape)):
                if shape[j] in head_sizes and shape[j] % model_n == 0:
                    parts[j] = "model"
                    placed = True
                    break
            if not placed and seq_shard:
                for j in range(bdim + 1, len(shape)):
                    if shape[j] >= 128 * model_n and shape[j] % model_n == 0:
                        parts[j] = "model"  # sequence dim
                        break
        return tuple(parts)

    return _tree_map(lambda leaf: NamedSharding(mesh, spec_to_placements(mesh, _spec(leaf))),
                     cache_desc)


def from_local(local: torch.Tensor, sharding: NamedSharding, shape) -> Any:
    """A DTensor of global `shape` under `sharding` whose shard on this rank
    is `local` (its box: `local_box`)."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(int(s) for s in shape)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=shape, stride=stride)


def zeros(shape, dtype: torch.dtype, sharding: NamedSharding) -> Any:
    """A DTensor of zeros of global `shape` under `sharding`: each rank
    allocates only its box, on the mesh's device."""
    start, stop = local_box(sharding, tuple(int(s) for s in shape))
    local = torch.zeros([b - a for a, b in zip(start, stop)], dtype=dtype,
                        device=mesh_device(sharding.mesh))
    return from_local(local, sharding, shape)


def zeros_like(x: Any, dtype: torch.dtype) -> Any:
    """Zeros of `dtype` shaped like tensor `x` on its device; for a DTensor,
    laid out like it (each rank allocates its box)."""
    from . import dist

    if dist.is_dtensor(x):
        return zeros(x.shape, dtype, layout_of(x))
    return torch.zeros(x.shape, dtype=dtype, device=x.device)


def layout_of(x: Any) -> NamedSharding | None:
    """A DTensor's `NamedSharding` (None for anything else)."""
    from . import dist

    if not dist.is_dtensor(x):
        return None
    return NamedSharding(x.device_mesh, tuple(x.placements))


def _chunk(extent: int, n: int, c: int) -> tuple[int, int]:
    """(start, length) of chunk `c` of `n` ceil-sized chunks of `extent`
    (torch's chunking: the last ones may be short or empty)."""
    size = -(-extent // n)
    start = min(c * size, extent)
    return start, min(size, extent - start)


def _gather_local(local: torch.Tensor, mesh, j: int, d: int, extent: int) -> torch.Tensor:
    """The whole of dim `d` from the `local` shards the ranks of mesh dim
    `j` hold, through `dist.all_gather` on that dim's group: staged through
    the host under gloo, whose all-gather of CUDA tensors crashes the
    process (PERF.md §6). Shards of uneven size are padded to the largest
    and cut back."""
    from . import dist

    n = mesh.size(j)
    size = -(-extent // n)
    if local.shape[d] < size:
        pad = list(local.shape)
        pad[d] = size - local.shape[d]
        local = torch.cat([local, local.new_zeros(pad)], dim=d)
    parts = dist.all_gather(local.contiguous(), group=mesh.get_group(j))
    return torch.cat([parts[c].narrow(d, 0, _chunk(extent, n, c)[1]) for c in range(n)], dim=d)


def gather_dim(local: torch.Tensor, mesh, placements, d: int, extent: int) -> torch.Tensor:
    """The whole of dim `d` (global size `extent`) of a tensor laid out by
    `placements`, from this rank's shard `local`: gathered over every mesh
    dim that splits `d`, the last split first (`_gather_local`, staged
    through the host). No gradient: the MoE's routing gathers its integer
    expert choices with it."""
    from torch.distributed.tensor import Shard

    dims = [j for j, p in enumerate(placements) if isinstance(p, Shard) and p.dim == d]
    extents = []
    for j in dims:  # the extent each split cuts, as `shard_box` cuts it
        extents.append(extent)
        extent = _chunk(extent, mesh.size(j), mesh.get_local_rank(j))[1]
    for j, e in zip(reversed(dims), reversed(extents)):
        local = _gather_local(local, mesh, j, d, e)
    return local


def _reduce_scatter_local(local: torch.Tensor, mesh, j: int, d: int) -> torch.Tensor:
    """This rank's chunk of dim `d` of the sum of `local` over the ranks of
    mesh dim `j`: `reduce_scatter_tensor` on the dim's group, staged
    through the host under gloo as `_gather_local` is, padded to equal
    chunks and cut back."""
    from . import dist

    n, c = mesh.size(j), mesh.get_local_rank(j)
    if n == 1:
        return local
    extent = local.shape[d]
    _, length = _chunk(extent, n, c)
    size = -(-extent // n)
    src = dist._staged(local)
    if size * n > extent:
        pad = list(src.shape)
        pad[d] = size * n - extent
        src = torch.cat([src, src.new_zeros(pad)], dim=d)
    # chunks laid out along dim 0, as the collective splits its input
    src = src.movedim(d, 0).contiguous()
    out = src.new_empty((size,) + tuple(src.shape[1:]))
    torch.distributed.reduce_scatter_tensor(out, src, group=mesh.get_group(j))
    return out.narrow(0, 0, length).movedim(0, d).to(local.device).contiguous()


class _GatherSplit(torch.autograd.Function):
    """Shard(d) -> Replicate over mesh dim `j`, with its gradient: the
    forward gathers the shards (`_gather_local`); the backward keeps this
    rank's chunk of the gradient, summed over the dim's group first where
    the gradient is a pending sum there (a reduce-scatter,
    `_reduce_scatter_local`), so FSDP's gathered weights and the gathered
    activations of `split_heads` carry their gradients.

    A dim split over several mesh dims (the batch over ('pod', 'data'))
    is split by each in mesh-dim order, each chunking the chunk before it;
    ending the split over `j` ends it over the later ones too, gathered the
    last first (as `gather_dim` does), and the backward scatters them back
    the first first. Earlier splits stay."""

    @staticmethod
    def forward(ctx, x, j: int):
        from torch.distributed.tensor import Replicate, Shard

        mesh, d = x.device_mesh, x.placements[j].dim
        split = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == d]
        extent = int(x.shape[d])
        for i in split:  # the extent each split cuts, as `shard_box` cuts it
            if i == j:
                break
            extent = _chunk(extent, mesh.size(i), mesh.get_local_rank(i))[1]
        dims, extents = [i for i in split if i >= j], []
        for i in dims:
            extents.append(extent)
            extent = _chunk(extent, mesh.size(i), mesh.get_local_rank(i))[1]
        local = x.to_local()
        for i, e in zip(reversed(dims), reversed(extents)):
            local = _gather_local(local, mesh, i, d, e)
        ctx.dims, ctx.d = dims, d
        gathered = tuple(Replicate() if i in dims else p for i, p in enumerate(x.placements))
        return from_local(local, NamedSharding(mesh, gathered), x.shape)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate, Shard

        dims, d = ctx.dims, ctx.d
        mesh = grad.device_mesh
        if any(isinstance(grad.placements[i], Shard) for i in dims):
            raise NotImplementedError(f"a gradient split along the gathered dim: {grad.placements}")
        local = grad.to_local()
        for i in dims:
            p = grad.placements[i]
            if p.is_partial():
                local = _reduce_scatter_local(local, mesh, i, d)
            elif isinstance(p, Replicate):  # every rank holds the whole gradient
                start, length = _chunk(int(local.shape[d]), mesh.size(i), mesh.get_local_rank(i))
                local = local.narrow(d, start, length).contiguous()
            else:
                raise NotImplementedError(f"a gradient laid out {grad.placements} over mesh dim {i}")
        placements = tuple(Shard(d) if i in dims else q for i, q in enumerate(grad.placements))
        return from_local(local, NamedSharding(mesh, placements), grad.shape), None


def _gather_split(x: Any, j: int) -> Any:
    """DTensor `x` with its split over mesh dim `j` gathered (Replicate
    there), gradient included (`_GatherSplit`)."""
    return _GatherSplit.apply(x, j)


def redistribute(x: Any, placements: tuple) -> Any:
    """DTensor `x` under `placements` on its own mesh, with two collectives
    only: a split that ends is gathered (`_gather_split`) and a pending sum
    that ends is added up (DTensor's all-reduce, which gloo runs on CUDA
    tensors); what is left is local: a split that starts is each rank's
    slice (`_split_local`), or a sum left pending."""
    from torch.distributed.tensor import Replicate, Shard

    placements = tuple(placements)
    for j, t in enumerate(placements):
        c = x.placements[j]  # a gather may end later mesh dims' splits too
        if isinstance(c, Shard) and c != t:
            x = _gather_split(x, j)
    summed = tuple(Replicate() if c.is_partial() and c != t else c
                   for c, t in zip(x.placements, placements))
    if summed != tuple(x.placements):
        x = x.redistribute(x.device_mesh, summed)
    if tuple(x.placements) == placements:
        return x
    if all(c == t or (isinstance(c, Replicate) and isinstance(t, Shard))
           for c, t in zip(x.placements, placements)):
        return _split_local(x, placements)
    return x.redistribute(x.device_mesh, placements)


def _split_local(x: Any, placements: tuple) -> Any:
    """Replicated DTensor `x` split where `placements` name a Shard: each
    rank keeps its box of its local tensor. Its gradient is declared a
    pending sum over the mesh dims that split (the rank's box of the
    gradient, zeros elsewhere), so autograd gathers nothing (DTensor's own
    backward of the slice is an all-gather, which gloo cannot run on CUDA
    tensors)."""
    from torch.distributed.tensor import Partial, Replicate

    shape = tuple(int(s) for s in x.shape)
    mesh = x.device_mesh
    start, _ = local_box(NamedSharding(mesh, tuple(x.placements)), shape)
    lo, hi = local_box(NamedSharding(mesh, placements), shape)
    local = x.to_local(grad_placements=tuple(
        Partial() if isinstance(c, Replicate) and c != t else c
        for c, t in zip(x.placements, placements)))
    for d, (a, b, s) in enumerate(zip(lo, hi, start)):
        if b - a != local.shape[d]:
            local = local.narrow(d, a - s, b - a)
    return from_local(local.contiguous(), NamedSharding(mesh, placements), shape)


def lay_out(x: Any, sharding: NamedSharding) -> Any:
    """`x` under `sharding`: a DTensor redistributed, a plain tensor taken as
    the global value (the same on every rank) of which each rank keeps its
    box."""
    from . import dist

    if dist.is_dtensor(x):
        return redistribute(x, sharding.placements)
    return dist.put_global(x, sharding)


class ActivationLayout:
    """The activation constraint `activate` binds to `models.nn.shard`:
    `layout(x, axes)` lays `x` out by the logical `axes` under `rules` on
    `mesh`, dropping mesh dims that do not divide their dim, and returns
    `x` as it is when `axes` does not name every dim."""

    def __init__(self, mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules
        self.sizes = mesh_shape(mesh)

    def _divides(self, dim: int, part) -> bool:
        if part is None:
            return True
        names = (part,) if isinstance(part, str) else part
        return dim % math.prod(self.sizes[a] for a in names) == 0

    def spec(self, shape, axes: tuple) -> tuple:
        spec = spec_for_axes(axes, self.rules, self.mesh)
        return tuple(p if self._divides(int(d), p) else None for d, p in zip(shape, spec))

    def __call__(self, x, axes: tuple):
        if len(axes) != x.ndim:
            return x
        return lay_out(x, NamedSharding(self.mesh, spec_to_placements(self.mesh, self.spec(x.shape, axes))))


@contextlib.contextmanager
def activate(mesh, rules: dict):
    """Bind the activation constraint used by `nn.shard` (and the mesh that
    `init_cache` lays caches out on) for the body; unbound on exit, also
    when the body raises."""
    from ..models import nn

    nn.set_shard_fn(ActivationLayout(mesh, rules))
    try:
        yield
    finally:
        nn.set_shard_fn(None)


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
    return _layout_of_mesh(mesh)[1]


def rank_at(mesh, coords: tuple[int, ...]) -> int:
    return _layout_of_mesh(mesh)[2][tuple(int(c) for c in coords)]


def neighbors(mesh, name: str, rank: int) -> tuple[int | None, int | None]:
    """(previous, next) rank of `rank` along the mesh dim `name` (None past
    either end)."""
    ax = _names(mesh).index(name)
    c = list(_coords(mesh)[rank])
    n = _layout_of_mesh(mesh)[0][ax]
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

    sizes, coords = _layout_of_mesh(mesh)[0], _coords(mesh)[rank]
    start = [0] * len(shape)
    stop = [int(s) for s in shape]
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d = int(p.dim) % max(len(shape), 1)
        n = sizes[i]
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


def owns_shard(x: Any) -> bool:
    """Whether this process is the lowest rank among the replicas of its
    shard of DTensor `x`: a statistic summed over the owners counts every
    unique shard once."""
    me = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    for _, _, ranks in unique_shards(x):
        if me in ranks:
            return ranks[0] == me
    return False


def shard_data(x: Any, rank: int) -> torch.Tensor:
    """`x`'s shard held by `rank`, which must be this process (no gather)."""
    me = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if int(rank) != me:
        raise ValueError(f"rank {rank} is not this process (rank {me}): its shard is remote")
    return x.to_local()


__all__ = [
    "ActivationLayout",
    "NamedSharding",
    "SERVE_RULES",
    "TRAIN_RULES",
    "TRAIN_RULES_TP",
    "activate",
    "axis_size",
    "cache_sharding",
    "from_local",
    "gather_dim",
    "lay_out",
    "layout_of",
    "local_box",
    "mesh_device",
    "mesh_of",
    "mesh_shape",
    "neighbors",
    "owns_shard",
    "place_params",
    "placements_to_spec",
    "redistribute",
    "shard_box",
    "shard_data",
    "spec_entries",
    "spec_for_axes",
    "spec_to_placements",
    "tree_shardings",
    "tree_specs",
    "unique_shards",
    "zeros",
    "zeros_like",
]
