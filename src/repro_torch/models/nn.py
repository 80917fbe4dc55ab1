"""Minimal declarative NN substrate: parameter descriptors and layers, in
torch.

Port of `repro.models.nn`. Parameters are declared as nested dicts of `P`
descriptors (shape, logical axes, init); `init_tree` draws them from an
explicit `torch.Generator` on an explicit device, and
`params_from_reference` carries a tree of the reference's weights (or its
optimizer state) across as numpy arrays, so both packages can compute with
the same weights.
The layers are plain functions on tensors.

Under a mesh (`runtime.sharding.activate`) the same layers take DTensors:
norms and pointwise ops run through DTensor's sharding propagation; the
products, the lookup, rope and attention, which are independent per
batch row and per head (the only dims the rules split there), run on each
rank's shards, each local operand declaring its gradient's layout, so
autograd plans no collective of DTensor's own. A product whose
contraction is split adds its partials in float32 over the mesh and
rounds once to the compute dtype; a weight split along a dim the product
cannot use (FSDP's 'embed' over 'data') is gathered first, its gradient
coming back as a reduce-scatter (`runtime.sharding._GatherSplit`). A norm
over a split last dim adds its rows' float32 sums of squares over the
split; the depthwise conv runs on each rank's channels; a fused output
cut where a mesh dim splits it (`split_last`) is gathered first.

Numerics follow the reference: activations in the compute dtype of `x`
(bfloat16 by default), every weight cast to it at each call (`dense`),
and float32 for the norm statistics, the RoPE angles, the attention
logits and softmax. Attention is the reference's plain form (an einsum,
the -1e30 mask, softmax in float32), not a fused library kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter descriptor: shape, logical axes (len == ndim), init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"P: shape {self.shape} and axes {self.axes} differ in rank")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a cache tensor (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def is_desc(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied to every leaf of a tree of nested dicts (and the
    matching leaves of the trees `rest`), keys in sorted order (the
    reference's `jax.tree_util` order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _fan_in(shape: tuple[int, ...]) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def init_param(p: P, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One parameter: zeros, ones, or normal draws from `generator` times
    the descriptor's scale (0.02 for embeddings, else 1/sqrt(fan_in)).
    The draws are torch's, not `jax.random`'s."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    scale = p.scale
    if scale is None:
        scale = 0.02 if p.init == "embed" else 1.0 / math.sqrt(max(_fan_in(p.shape), 1))
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(p.dtype)


def init_tree(tree: Any, generator: torch.Generator, *, device=None, shardings: Any = None) -> Any:
    """Materialize a descriptor tree into parameters on `device` (default
    the GPU), drawn from `generator`, which must live on that device.

    With `shardings` (a matching tree of `runtime.sharding.NamedSharding`s,
    `tree_shardings`), each leaf is drawn whole, in the same order, and
    each rank keeps only its box as a DTensor: the values equal the
    unsharded draw's, and one whole leaf at a time is resident."""
    dev = _device.resolve(device)
    if shardings is None:
        return tree_map(lambda p: init_param(p, generator, dev), tree)
    from ..runtime import dist

    return tree_map(lambda p, sh: dist.put_global(init_param(p, generator, dev), sh),
                    tree, shardings)


def abstract_tree(tree: Any) -> Any:
    """Shapes and dtypes with no storage (meta tensors): the layout rules'
    `abstract` argument and dry runs."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), tree)


def axes_tree(tree: Any) -> Any:
    """The logical-axis tree matching the params (for the layout rules of
    `runtime/sharding.py`)."""
    return tree_map(lambda p: p.axes, tree)


def _reference_leaf(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def params_from_reference(tree: Any, *, device=None) -> Any:
    """The reference's parameter tree, or its optimizer state (``{"adam":
    {"m", "v", "step"}, "gc": {"residual"}}``), as nested dicts of numpy
    arrays (``jax.tree_util.tree_map(np.asarray, tree)``), as tensors on
    `device` (default the GPU): the same keys, shapes and dtypes (Adam's
    step a 0-d int32 tensor)."""
    dev = _device.resolve(device)
    return tree_map(lambda a: _reference_leaf(a, dev), tree)


def stack_layers(descs: list[Any]) -> Any:
    """Stack homogeneous per-layer descriptor trees along a leading 'layers'
    axis (the reference's scan-over-layers layout)."""
    n = len(descs)
    return tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype), descs[0]
    )


def unstack(tree: Any, n: int) -> list[Any]:
    """The `n` layers of a tree stacked on a leading axis, as views
    (`torch.unbind`, whose backward stacks the layers' gradients in one
    copy where indexing would add a full-size gradient per layer)."""
    leaves = tree_map(lambda a: torch.unbind(a, 0), tree)
    return [tree_map(lambda t: t[i], leaves) for i in range(n)]


def layer(tree: Any, i: int) -> Any:
    """Layer `i` of a tree stacked on a leading axis: views, no copy, but
    for a DTensor whose stack is split over the mesh, where it is a copy
    gathered from the ranks that hold layer `i` (`put_layer` writes it
    back)."""
    return tree_map(lambda a: _layer_of(a, i) if is_sharded(a) else a[i], tree)


def put_layer(tree: Any, i: int, values: Any) -> None:
    """After in-place writes to `values = layer(tree, i)`: the ranks that
    hold layer `i` of a DTensor whose stack is split copy their part of the
    gathered layer back (views need nothing)."""

    def _put(a, v):
        if not is_sharded(a) or not _split_dims(a, 0):
            return
        start, stop = _box(a)
        if start[0] <= i < stop[0]:
            a.to_local()[i - start[0]].copy_(v.to_local())

    tree_map(_put, tree, values)


# ---------------------------------------------------------------------------
# sharding annotation hook (bound by runtime.sharding.activate)
# ---------------------------------------------------------------------------

_SHARD_FN = None


def set_shard_fn(fn) -> None:
    global _SHARD_FN
    _SHARD_FN = fn


def shard_fn():
    """The bound constraint (`runtime.sharding.ActivationLayout`), or None
    outside a mesh."""
    return _SHARD_FN


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain activation `x` to logical axes (no-op outside a mesh)."""
    if _SHARD_FN is None:
        return x
    return _SHARD_FN(x, axes)


def is_sharded(x) -> bool:
    """True for a DTensor (a tensor laid out over a mesh)."""
    if not isinstance(x, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _split_dims(x, dim: int) -> list[int]:
    """The mesh dims that split tensor dim `dim` of DTensor `x`."""
    from torch.distributed.tensor import Shard

    return [j for j, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]


def _box(x) -> tuple[tuple, tuple]:
    """(start, stop) of this rank's shard of DTensor `x`."""
    from ..runtime import sharding as _sh

    return _sh.local_box(_sh.NamedSharding(x.device_mesh, tuple(x.placements)), tuple(x.shape))


def _like(local: torch.Tensor, x, shape) -> Any:
    """A DTensor of global `shape` laid out as `x`, whose shard here is
    `local`."""
    from ..runtime import sharding as _sh

    return _sh.from_local(local, _sh.NamedSharding(x.device_mesh, tuple(x.placements)), shape)


def _layer_of(a, i: int):
    """Layer `i` of DTensor `a`, stacked on dim 0. Unsplit stacks give a
    view. A split stack gives a copy: the ranks that hold layer `i` send
    it, the others zeros, summed over the splitting mesh dims."""
    from torch.distributed.tensor import Partial, Shard

    split = _split_dims(a, 0)
    if not split:
        return a[i]
    local = a.to_local()
    start, stop = _box(a)
    mine = (local[i - start[0]] if start[0] <= i < stop[0]
            else torch.zeros(local.shape[1:], dtype=local.dtype, device=local.device))
    pending = tuple(Partial() if j in split else Shard(p.dim - 1) if isinstance(p, Shard) else p
                    for j, p in enumerate(a.placements))
    from ..runtime import sharding as _sh

    return reduce_partial(_sh.from_local(mine.contiguous(), _sh.NamedSharding(a.device_mesh, pending),
                                         a.shape[1:]))


def local_value(x):
    """The value of a DTensor that every rank holds whole (all placements
    Replicate) as a plain tensor; any other `x` as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    if not all(isinstance(p, Replicate) for p in x.placements):
        raise ValueError(f"local_value needs a replicated DTensor, got {x.placements}")
    return x.to_local()


def write_rows(cache: torch.Tensor, rows: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, rows] = new`` in place (`index_copy_` on dim 1). A DTensor
    cache takes `new` in its own layout and each rank writes its shard;
    where the cache's dim 1 (its sequence) is split, `new` is whole along
    it and each rank writes the rows of `rows` that fall in its band
    (`_write_band`)."""
    if not is_sharded(cache):
        cache.index_copy_(1, rows, new)
        return
    from torch.distributed.tensor import Replicate

    from ..runtime import sharding as _sh

    band = _split_dims(cache, 1)
    want = tuple(Replicate() if j in band else p for j, p in enumerate(cache.placements))
    new = _sh.redistribute(new, want).to_local()
    if not band:
        cache.to_local().index_copy_(1, rows, new)
        return
    _write_band(cache.to_local(), rows - _box(cache)[0][1], new)


def _write_band(local: torch.Tensor, j: torch.Tensor, new: torch.Tensor) -> None:
    """``local[:, j[i]] = new[:, i]`` for the i whose row j[i] lies in the
    band [0, local.shape[1]), the others dropped, with no data-dependent
    shape: each dropped row is sent to the band's first written row with
    that row's value (or, when none is written, to row 0 with its own
    value), so every duplicate index of the `index_copy_` carries the same
    value."""
    nb = local.shape[1]
    hit = (j >= 0) & (j < nb)
    first = torch.argmax(hit.to(torch.int32)).reshape(1)  # the first row in the band, 0 if none
    some = hit.any()
    target = torch.where(hit, j, torch.where(some, j.index_select(0, first), 0))
    zero = torch.zeros(1, dtype=torch.long, device=local.device)
    fill = torch.where(some, new.index_select(1, first), local.index_select(1, zero))
    keep = hit.view((1, -1) + (1,) * (new.ndim - 2))
    local.index_copy_(1, target, torch.where(keep, new, fill))


def write_state(cache: torch.Tensor, new: torch.Tensor) -> None:
    """``cache.copy_(new)`` in place (a recurrent state, a conv window, the
    encoder memory). A DTensor cache takes `new` in its own layout (a
    split of `new` the cache does not have is gathered) and each rank
    writes its shard."""
    if not is_sharded(cache):
        cache.copy_(new)
        return
    from ..runtime import sharding as _sh

    cache.to_local().copy_(_sh.redistribute(new.detach(), tuple(cache.placements)).to_local())


def local_part(t, split: set) -> torch.Tensor:
    """DTensor `t`'s local tensor, for a computation whose work each rank of
    the mesh dims `split` does a different part of (its rows, its heads):
    where `t` is whole over such a dim, each rank's use of it gives part of
    its gradient, declared a pending sum there."""
    from torch.distributed.tensor import Partial, Replicate

    return t.to_local(grad_placements=tuple(
        Partial() if j in split and isinstance(p, Replicate) else p
        for j, p in enumerate(t.placements)))


def split_mesh_dims(x) -> set:
    """The mesh dims that split some dim of DTensor `x`."""
    from torch.distributed.tensor import Shard

    return {j for j, p in enumerate(x.placements) if isinstance(p, Shard)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim, statistics in float32. A DTensor whose
    last dim is split (`_rms_norm_split`) adds its rows' sums of squares
    over the split."""
    if is_sharded(x) and _split_dims(x, x.ndim - 1):
        return _rms_norm_split(x, scale, eps)
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


class _SumOver(torch.autograd.Function):
    """The sum of a local tensor over the ranks of mesh dims `dims` (an
    all-reduce each), which every rank then reads in its own way: the
    backward sums the ranks' gradients the same way. (DTensor's own
    backward of a pending sum leaves such a gradient pending in torch
    releases before the one that made it add it up.)"""

    @staticmethod
    def forward(ctx, local, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _sum_over(local, mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.mesh, ctx.dims), None, None


def _sum_over(local: torch.Tensor, mesh, dims) -> torch.Tensor:
    from torch.distributed.tensor import Partial, Replicate

    from ..runtime import sharding as _sh

    pend = tuple(Partial() if j in dims else Replicate() for j in range(mesh.ndim))
    whole = _sh.from_local(local.contiguous(), _sh.NamedSharding(mesh, pend), local.shape)
    return reduce_partial(whole).to_local()


def _rms_norm_split(x, scale, eps: float):
    """`rms_norm` of DTensor `x` whose last dim is split: each rank squares
    and sums its columns in float32, the sums are added over the split
    (`_SumOver`), and each rank scales its columns by its box of `scale`.
    The result differs from the whole row's only by the order of its
    float32 additions."""
    dims = tuple(_split_dims(x, x.ndim - 1))
    xl = x.to_local()
    xf = xl.to(torch.float32)
    ss = _SumOver.apply(torch.sum(torch.square(xf), dim=-1, keepdim=True), x.device_mesh, dims)
    start, stop = _box(x)
    sc = scale.to(torch.float32)
    if is_sharded(scale):
        sc = local_part(scale, split_mesh_dims(x)).to(torch.float32)
    sc = sc[start[-1]:stop[-1]]
    out = xf * torch.rsqrt(ss / x.shape[-1] + eps) * sc
    return _like(out.to(x.dtype), x, x.shape)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in the compute dtype of x (the
    weight is cast at every call, as in the reference).

    DTensors run shard by shard (`_dense_sharded`). A product whose
    contraction is split (row-parallel) gives partial sums: they are
    formed and added over the mesh in float32 and rounded once to the
    compute dtype, so every rank holds the same bits and the result
    differs from the unsharded product only by the order of its float32
    additions."""
    if is_sharded(x) or is_sharded(w):
        return _dense_sharded(x, w)
    return torch.matmul(x, w.to(x.dtype))


def _dense_sharded(x, w):
    """`dense` on DTensors, as one local product a rank. The weight first
    loses every split the product cannot use (`_gathered_weight`). Then,
    per mesh dim, (x, w) is one of: x split by a leading dim and w whole
    (the output and x's gradient split alike, w's gradient pending),
    x whole and w split by columns (column-parallel: the output split by
    columns, x's gradient pending), both split along the contraction
    (row-parallel: the output pending), or both whole. Each local operand
    declares its gradient's layout (`to_local(grad_placements=)`), so
    autograd needs no collective of DTensor's own here; the pending sums
    are added where they are consumed."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..runtime import sharding as _sh

    if not is_sharded(x):
        raise TypeError("a sharded weight takes activations laid out on its mesh")
    w = _gathered_weight(x, w)
    last = x.ndim - 1
    out, gx, gw = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(last):  # split contraction: the rules split w's rows alike
            if pw != Shard(0):
                raise NotImplementedError(f"x laid out {x.placements}, w {w.placements}")
            out.append(Partial())
            gx.append(px)
            gw.append(pw)
        elif isinstance(px, Shard):
            out.append(px)
            gx.append(px)
            gw.append(Partial())
        elif pw == Shard(1):
            out.append(Shard(last))
            gx.append(Partial())
            gw.append(pw)
        else:
            out.append(Replicate())
            gx.append(px)
            gw.append(pw)
    xl = x.to_local(grad_placements=tuple(gx))
    wl = w.to_local(grad_placements=tuple(gw)).to(x.dtype)
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    if any(p.is_partial() for p in out):
        y = torch.matmul(xl.to(torch.float32), wl.to(torch.float32))
        return reduce_partial(_sh.from_local(y, _sh.NamedSharding(x.device_mesh, tuple(out)),
                                             shape)).to(x.dtype)
    return _sh.from_local(torch.matmul(xl, wl), _sh.NamedSharding(x.device_mesh, tuple(out)), shape)


def _gathered_weight(x, w):
    """Weight `w` (d_in, d_out) with every split the product with `x` does
    not take gathered (`runtime.sharding.redistribute`, which carries the
    gradient): a d_in split stays where `x` is split along its last dim
    over the same mesh dim (row-parallel), a d_out split where `x` is whole
    over it (column-parallel)."""
    from torch.distributed.tensor import Replicate, Shard

    keep = []
    for j, p in enumerate(w.placements):
        xp = x.placements[j] if is_sharded(x) else Replicate()
        if isinstance(p, Shard):
            row = p.dim == w.ndim - 2 and xp == Shard(x.ndim - 1)
            col = p.dim == w.ndim - 1 and isinstance(xp, Replicate)
            p = p if row or col else Replicate()
        keep.append(p)
    if tuple(keep) == tuple(w.placements):
        return w
    from ..runtime import sharding as _sh

    return _sh.redistribute(w, tuple(keep))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table split over its rows (the vocab)
    looks up, on each rank, the tokens its rows hold and gives zeros for
    the rest: a pending sum over the splitting mesh dims (`reduce_partial`
    adds it exactly, one term being nonzero), laid out by the tokens' batch
    split elsewhere. The tokens must be whole along the vocab split. A
    table split along its columns (FSDP, `TRAIN_RULES`) is gathered along
    them first. The table's gradient is each rank's rows' scatter of its
    tokens' gradients, a pending sum over the mesh dims that split the
    tokens but not the table."""
    if not is_sharded(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not is_sharded(tokens):
        raise TypeError("a sharded table takes tokens laid out on its mesh "
                        "(launch.dryrun.batch_shardings)")
    if _split_dims(table, 1):
        from ..runtime import sharding as _sh

        table = _sh.redistribute(table, tuple(Replicate() if p == Shard(1) else p
                                              for p in table.placements))
    rows = _split_dims(table, 0)
    if any(not isinstance(tokens.placements[j], Replicate) for j in rows):
        raise NotImplementedError(
            f"a lookup in a table laid out {table.placements} by tokens laid out "
            f"{tokens.placements} (the tokens must be whole along the vocab split)")
    grads = tuple(Partial() if isinstance(p, Replicate) and isinstance(t, Shard) else p
                  for p, t in zip(table.placements, tokens.placements))
    local = table.to_local(grad_placements=grads)
    start, _ = _box(table)
    ids = tokens.to_local().long() - start[0]
    hit = (ids >= 0) & (ids < local.shape[0])
    out = torch.where(hit[..., None], local[ids.clamp(0, local.shape[0] - 1)],
                      torch.zeros((), dtype=local.dtype, device=local.device))
    from ..runtime import sharding as _sh

    pending = tuple(Partial() if j in rows else p for j, p in enumerate(tokens.placements))
    return _sh.from_local(out, _sh.NamedSharding(table.device_mesh, pending),
                          tuple(tokens.shape) + (table.shape[1],))


def reduce_partial(x):
    """DTensor `x` with its pending sums (Partial placements) added over the
    mesh (an all-reduce each); anything else as it is."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, L, n * dh) -> (B, L, n, dh). A DTensor whose last dim is split
    over more ranks than divide `n` is gathered along it first (the
    activation guard then leaves those heads replicated)."""
    b, l = x.shape[:2]
    if is_sharded(x):
        split = _split_dims(x, x.ndim - 1)
        if n % math.prod(x.device_mesh.size(j) for j in split):
            from torch.distributed.tensor import Replicate

            from ..runtime import sharding as _sh

            x = _sh.redistribute(x, tuple(Replicate() if j in split else p
                                          for j, p in enumerate(x.placements)))
    return x.reshape(b, l, n, dh)


def split_last(x: torch.Tensor, *sizes: int) -> tuple:
    """`x` cut along its last dim into consecutive parts of `sizes`. A
    DTensor is cut shard by shard, each part laid out as `x`; where a mesh
    dim splits the last dim (a fused projection's columns, whose split
    need not fall on the parts' boundaries), `x` is gathered along it
    first (`runtime.sharding.redistribute`, which carries the gradient)."""
    if not is_sharded(x):
        return tuple(torch.split(x, sizes, dim=-1))
    split = _split_dims(x, x.ndim - 1)
    if split:
        from torch.distributed.tensor import Replicate

        from ..runtime import sharding as _sh

        x = _sh.redistribute(x, tuple(Replicate() if j in split else p
                                      for j, p in enumerate(x.placements)))
    return tuple(_like(t.contiguous(), x, tuple(x.shape[:-1]) + (n,))
                 for t, n in zip(torch.split(x.to_local(), sizes, dim=-1), sizes))


def cat(xs, dim: int) -> torch.Tensor:
    """``torch.cat(xs, dim)``; DTensors of one layout, none of them split
    along `dim`, shard by shard."""
    if not is_sharded(xs[0]):
        return torch.cat(xs, dim=dim)
    d = dim % xs[0].ndim
    if _split_dims(xs[0], d) or any(tuple(t.placements) != tuple(xs[0].placements) for t in xs):
        raise ValueError(f"cat along dim {d} of {[tuple(t.placements) for t in xs]}")
    shape = list(xs[0].shape)
    shape[d] = sum(int(t.shape[d]) for t in xs)
    return _like(torch.cat([t.to_local() for t in xs], dim=d), xs[0], tuple(shape))


def on_shards(fn: Callable, x: torch.Tensor, shape) -> torch.Tensor:
    """`fn(x)` for an `fn` that acts on each shard alone and keeps the
    layout (an unsqueeze after the split dims, a cast): a DTensor's shard
    is mapped and laid out as `x`, with global `shape`."""
    if not is_sharded(x):
        return fn(x)
    return _like(fn(x.to_local()), x, shape)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: (B, L, H, Dh) with even Dh; positions: (B, L).
    A DTensor `x` (split by batch and heads) is rotated shard by shard;
    its positions are then (1, L), the same for every row."""
    if is_sharded(x):
        return _like(rope(x.to_local(), positions, theta), x, x.shape)
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, L, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: query-chunk size for the memory-bounded attention path
ATTN_Q_CHUNK = 1024


def _is_vector(v) -> bool:
    return isinstance(v, torch.Tensor) and v.ndim > 0


def _attn_direct(qr, k, v, causal, q_offset, window, kv_len, dh):
    b, lq = qr.shape[:2]
    lk = k.shape[1]
    dev = qr.device
    logits = torch.einsum("blhrd,bmhd->bhrlm", qr, k).to(torch.float32)
    logits = logits / math.sqrt(dh)
    if _is_vector(q_offset) or _is_vector(kv_len):
        # per-slot clocks (paged serving, DESIGN.md §9): q_offset / kv_len
        # are (B,) vectors, so the mask gains a batch axis
        qpos = torch.arange(lq, device=dev)[None, :, None] + torch.reshape(
            torch.as_tensor(q_offset, device=dev), (-1, 1, 1))
        kpos = torch.arange(lk, device=dev)[None, None, :]
        mask = torch.ones((1, lq, lk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        if kv_len is not None:
            mask = mask & (kpos < torch.reshape(torch.as_tensor(kv_len, device=dev), (-1, 1, 1)))
        logits = torch.where(mask[:, None, None], logits, -1e30)
    else:
        qpos = torch.arange(lq, device=dev)[:, None] + q_offset
        kpos = torch.arange(lk, device=dev)[None, :]
        mask = torch.ones((lq, lk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        if kv_len is not None:
            mask = mask & (kpos < kv_len)
        logits = torch.where(mask[None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(qr.dtype)
    return torch.einsum("bhrlm,bmhd->blhrd", w, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    window: int | None = None,
    kv_len: torch.Tensor | int | None = None,
    q_chunk: int | None = None,
) -> torch.Tensor:
    """GQA attention. q: (B, Lq, Hq, Dh); k/v: (B, Lk, Hkv, Dh|Dv).

    `q_offset`: absolute position of q[0] (decode). `window`: sliding-window
    size. `kv_len`: valid KV prefix length (decode with preallocated cache).
    `q_offset` and `kv_len` may also be per-slot (B,) vectors, the paged
    serving tier's per-slot clocks (DESIGN.md §9), which batches the mask.

    Queries longer than `q_chunk` (default `ATTN_Q_CHUNK`) run in chunks.
    With a static (int) q_offset the causal structure also truncates each
    chunk's KV prefix (the flash-attention triangle saving).

    DTensors (split by batch and heads) run shard by shard
    (`_attention_sharded`).
    """
    if is_sharded(q):
        return _attention_sharded(q, k, v, causal, q_offset, window, kv_len, q_chunk)
    b, lq, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qr = q.reshape(b, lq, hkv, rep, dh)
    qc = q_chunk or ATTN_Q_CHUNK
    if lq <= qc:
        out = _attn_direct(qr, k, v, causal, q_offset, window, kv_len, dh)
        return out.reshape(b, lq, hq, v.shape[-1])
    static_off = isinstance(q_offset, int)
    outs = []
    for s in range(0, lq, qc):
        e = min(lq, s + qc)
        qs = qr[:, s:e]
        if static_off and causal and kv_len is None:
            # static causal truncation of the KV prefix (triangle saving)
            hi = min(k.shape[1], q_offset + e)
            lo = max(0, q_offset + s - window + 1) if window is not None else 0
            lo = (lo // 128) * 128  # the reference's lane-aligned slices
            out = _attn_direct(
                qs, k[:, lo:hi], v[:, lo:hi], causal, q_offset + s - lo, window, None, dh
            )
        else:
            out = _attn_direct(qs, k, v, causal, q_offset + s, window, kv_len, dh)
        outs.append(out)
    return torch.cat(outs, dim=1).reshape(b, lq, hq, v.shape[-1])


def _attention_sharded(q, k, v, causal, q_offset, window, kv_len, q_chunk):
    """`attention` on DTensors: k and v are laid out with q's batch split
    and, where their heads divide, its head split; each rank attends its
    own rows and query heads against the KV heads those need (the GQA
    group's slice of the local K/V).

    K and V split along their sequence (a cache laid out by
    `cache_sharding(seq_shard=True)`, or one whose length matched a head
    count) stay split: the queries are gathered over those mesh dims, each
    rank scores its band of keys and the bands' partial softmaxes are
    combined over them (`_attention_split_k`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if _is_vector(q_offset) or _is_vector(kv_len):
        raise NotImplementedError(
            "per-slot clocks (the paged KV pool) under a mesh: the reference never runs the "
            "paged pool under a mesh (its run_continuous returns before it makes one)")
    mesh = q.device_mesh
    if not all(p == Shard(0) or p == Shard(2) or isinstance(p, Replicate) for p in q.placements):
        raise ValueError(f"attention splits queries by batch and heads only, got {q.placements}")
    from ..runtime import sharding as _sh

    seq = _split_dims(k, 1)
    q_placements = tuple(q.placements)
    if seq:
        q = _sh.redistribute(q, tuple(Replicate() if j in seq else p
                                      for j, p in enumerate(q.placements)))
    hq, hkv = q.shape[2], k.shape[2]
    rep = hq // hkv
    head_split = _split_dims(q, 2)
    kv_heads_split = hkv % math.prod(mesh.size(j) for j in head_split) == 0
    want = tuple(Shard(1) if j in seq else
                 p if (p == Shard(0) or (p == Shard(2) and kv_heads_split)) else Replicate()
                 for j, p in enumerate(q.placements))
    k, v = _sh.redistribute(k, want), _sh.redistribute(v, want)
    # a K/V head that several ranks' query heads read gets each rank's part
    # of its gradient: a pending sum over the mesh dims that split q only
    grads = tuple(Partial() if isinstance(p, Replicate) and isinstance(pq, Shard) else p
                  for p, pq in zip(k.placements, q.placements))
    ql, kl, vl = q.to_local(), k.to_local(grad_placements=grads), v.to_local(grad_placements=grads)
    h0, hq_loc = _box(q)[0][2], ql.shape[2]
    g0 = _box(k)[0][2]
    if hq_loc % rep == 0 and h0 % rep == 0:
        heads = slice(h0 // rep - g0, h0 // rep - g0 + hq_loc // rep)
    elif h0 // rep == (h0 + hq_loc - 1) // rep:
        heads = slice(h0 // rep - g0, h0 // rep - g0 + 1)  # one group's part
    else:  # the shard straddles groups: one KV head per query head
        heads = torch.arange(h0, h0 + hq_loc, device=kl.device) // rep - g0
    shape = (q.shape[0], q.shape[1], hq, v.shape[-1])
    if not seq:
        out = attention(ql, kl[:, :, heads], vl[:, :, heads], causal, q_offset, window,
                        kv_len, q_chunk)
        return _like(out.contiguous(), q, shape)
    out = _attention_split_k(ql, kl[:, :, heads], vl[:, :, heads], causal, q_offset, window,
                             kv_len, q_chunk, _box(k)[0][1], mesh, seq)
    return _sh.redistribute(_like(out.contiguous(), q, shape), q_placements)


def _attn_partial(qr, k, v, causal, q_offset, window, kv_len, dh: int, k0: int):
    """`_attn_direct` on a band of keys whose first is global position
    `k0`, before normalization: (the weighted values (b, l, hkv, rep, dv)
    in float32, each row's float32 max over the band (b, hkv, rep, l), the
    sum of its exponentials). The weights enter the value product in the
    values' dtype, as the reference's softmax weights do."""
    lq, lk = qr.shape[1], k.shape[1]
    dev = qr.device
    logits = torch.einsum("blhrd,bmhd->bhrlm", qr, k).to(torch.float32) / math.sqrt(dh)
    qpos = torch.arange(lq, device=dev)[:, None] + q_offset
    kpos = k0 + torch.arange(lk, device=dev)[None, :]
    mask = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    logits = torch.where(mask[None, None, None], logits, -1e30)
    top = torch.amax(logits, dim=-1)
    p = torch.exp(logits - top[..., None])
    out = torch.einsum("bhrlm,bmhd->blhrd", p.to(v.dtype), v).to(torch.float32)
    return out, top, p.sum(-1)


def combine_split_k(out, top, total, mesh, dims) -> torch.Tensor:
    """The softmax-weighted values of the whole key range from each rank's
    partial over its band (the split-K combine): `out` (b, l, h..., d) the
    band's unnormalized weighted values, `top` and `total` (b, h..., l)
    its rows' float32 max and sum of exponentials. The maxima are combined
    by an all-reduce max over the mesh dims `dims`, then the rescaled
    values and sums by one all-reduce sum; float32 (b, l, h..., d)."""
    from torch.distributed.tensor import Partial, Replicate

    from ..runtime import sharding as _sh

    def over(x, op):
        pend = tuple(Partial(op) if j in dims else Replicate() for j in range(mesh.ndim))
        return reduce_partial(_sh.from_local(x.contiguous(), _sh.NamedSharding(mesh, pend),
                                             tuple(x.shape))).to_local()

    whole = over(top, "max")
    c = torch.exp(top - whole)  # 0 for a band with no key left unmasked
    rows = tuple(range(1, top.ndim - 1))
    cl = c.permute(0, top.ndim - 1, *rows)[..., None]  # (b, l, h..., 1)
    num = out * cl
    both = over(torch.cat([num.reshape(-1), (total * c).reshape(-1)]), "sum")
    num, den = both[:num.numel()].reshape(num.shape), both[num.numel():].reshape(c.shape)
    return num / den.permute(0, top.ndim - 1, *rows)[..., None]


def _attention_split_k(ql, kl, vl, causal, q_offset, window, kv_len, q_chunk, k0: int, mesh,
                       dims) -> torch.Tensor:
    """Attention of local queries (b, lq, hq, dh) over this rank's band of
    keys and values (b, lk, hkv, ·), the band starting at global position
    `k0`, the bands split over the mesh dims `dims`: each chunk of queries
    (`q_chunk`, default `ATTN_Q_CHUNK`) takes its partial softmax on the
    band (`_attn_partial`) and the split-K combine (`combine_split_k`).
    Every rank of `dims` ends with the same (b, lq, hq, dv) in q's dtype."""
    b, lq, hq, dh = ql.shape
    hkv = kl.shape[2]
    qr = ql.reshape(b, lq, hkv, hq // hkv, dh)
    qc = q_chunk or ATTN_Q_CHUNK
    outs = []
    for s in range(0, lq, qc):
        part = _attn_partial(qr[:, s:s + qc], kl, vl, causal, q_offset + s, window, kv_len, dh,
                             k0)
        outs.append(combine_split_k(*part, mesh, dims))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, lq, hq, vl.shape[-1]).to(ql.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                prev: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of x (B, L, C) with kernel w (K, C) and bias
    b (C,), in the dtype of x, then silu in float32 (the Mamba2 and mLSTM
    input convs). The K-1 steps before x are `prev` (B, K-1, C), a decode
    cache, or zeros. Returns (out, the last K-1 input steps: the next
    call's `prev`).

    DTensors run on each rank's rows and channels (`_causal_conv_sharded`)."""
    if is_sharded(x):
        return _causal_conv_sharded(x, w, b, prev)
    k, l = w.shape[0], x.shape[1]
    if prev is not None:
        ext = torch.cat([prev.to(x.dtype), x], dim=1)
    else:
        ext = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    wins = torch.stack([ext[:, i:i + l, :] for i in range(k)], dim=2)  # (B, L, K, C)
    out = torch.einsum("blkc,kc->blc", wins, w.to(x.dtype)) + b.to(x.dtype)
    return torch.nn.functional.silu(out.to(torch.float32)).to(x.dtype), ext[:, -(k - 1):, :]


def _causal_conv_sharded(x, w, b, prev):
    """`causal_conv` of DTensor x (B, L, C), split by batch and possibly by
    channels: the kernel and bias are laid out with x's channel split (a
    split x does not have is gathered), the window `prev` (a cache) with
    x's layout, and each rank convolves its own rows and channels. The
    kernel's and bias's gradients are pending sums over the mesh dims that
    split only x (its rows); the returned window is laid out as x."""
    from torch.distributed.tensor import Replicate, Shard

    from ..runtime import sharding as _sh

    chan = _split_dims(x, 2)
    wl = _sh.redistribute(w, tuple(Shard(1) if j in chan else Replicate()
                                   for j in range(x.device_mesh.ndim)))
    bl = _sh.redistribute(b, tuple(Shard(0) if j in chan else Replicate()
                                   for j in range(x.device_mesh.ndim)))
    rows = split_mesh_dims(x) - set(chan)
    if prev is not None:
        prev = _sh.redistribute(prev.detach(), tuple(x.placements)).to_local()
    out, window = causal_conv(x.to_local(), local_part(wl, rows), local_part(bl, rows), prev)
    return _like(out, x, x.shape), _like(window.contiguous(), x,
                                         (x.shape[0], w.shape[0] - 1, x.shape[2]))


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    h = shard(h, "batch", None, "mlp")
    return dense(h, w_down)


def gelu_mlp(x, w_up, w_down):
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.nn.functional.gelu(dense(x, w_up).to(torch.float32), approximate="tanh")
    h = shard(h.to(x.dtype), "batch", None, "mlp")
    return dense(h, w_down)


def relu2_mlp(x, w_up, w_down):
    h = torch.square(torch.relu(dense(x, w_up).to(torch.float32))).to(x.dtype)
    h = shard(h, "batch", None, "mlp")
    return dense(h, w_down)
