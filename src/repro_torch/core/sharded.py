"""Shard-local selection engine: distributed Algorithm 1 (DESIGN.md §6).

Port of `repro.core.sharded`, on `torch.distributed`. The paper's headline
setting is parallel: many ranks, each compressing its own fields. Here
Stage I/II of Algorithm 1 runs on every rank's LOCAL shard of a DTensor
(`dtensor.to_local()`, explicit collectives, no `redistribute` or
`full_tensor`), and the per-field decision is reconciled with a cheap
collective of the §4-§5 sufficient statistics: no field is ever gathered
on the selection path, and the byte encoders then run per shard (each
rank encodes only the bytes it holds). Under more than one process the
merged statistics, and so every decision and bound, are identical on all
ranks; `encode_plan(..., host=)` keeps the segments a rank owns, which the
checkpoint writer's per-host segment files build on.

Two reconciliation strategies, both behind `plan_tree`:

* ``stats`` (the fixed_accuracy default): each rank computes its owned
  sample blocks' sufficient statistics: exact ZFP coder bits (integers),
  the EC-point truncation error energy, and the SZ integer-Lorenzo
  residual bin counts at the iso-PSNR bin size. A `dist.psum` merges them
  (integers exactly; the float energy in rank order), and the §4-§5
  formulas run on the merged statistics, so decisions agree with the
  unsharded batched path to estimator ulps.
* ``samples`` (the target modes, and an exact option for fixed_accuracy):
  each rank extracts its owned sample blocks with a one-plane halo
  exchange, they are all-gathered and put back in global block order, and
  the batched deciders (`selector._run_select_batches`, the §7 controller)
  run on them. The blocks are bit for bit those `estimator.gather_blocks`
  takes from the whole field, so the decisions equal the unsharded ones.

Block ownership: the global 4^n sample lattice (`estimator.block_starts`
on the folded global view) is partitioned by shard; a block belongs to the
shard containing it, and within a replica group blocks go round-robin over
the replicas by rank. Eligibility needs every sharded view dim to split
evenly into 4-aligned shards (one mesh dim per tensor dim); anything else
(uneven shards, a sharded middle dim of a >3-D fold, a pending reduction)
takes the gather path per field (`FieldPlan.path == "gather"`), which is
the unsharded engine, so correctness never depends on the layout.

The halo: SZ's Lorenzo residuals predict each sample block from its
ORIGINAL neighbours (zero outside the domain). A shard's leading block
along a sharded dim needs the previous shard's trailing plane, so each
sharded dim prepends one plane received from the previous rank along that
mesh dim (`dist.halo`; zeros at the global boundary); corner halos compose
because each exchange forwards the already-extended array.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from .. import device as _device
from ..runtime import dist
from ..runtime import sharding as rsh
from . import codecs as _codecs
from . import controller as ctl
from . import estimator as est
from . import quality as qual
from . import selector as select_mod
from .embedded import align_blocks, exact_coder_bits_blocks, plane_step
from .policy import TARGET_FIELD, Policy, policy_from_kwargs
from .selector import (
    Selection,
    _degenerate_selection,
    _fold_ndim,
    _max_batch_blocks,
    _next_pow2,
    _pick_codec,
    _run_select_batches,
)
from .transforms import block_transform_nd, bot_linf_gain, bot_matrix
from .xla_f32 import _exp2

# ---------------------------------------------------------------------------
# Layout analysis: can this array's layout carry the engine?
# ---------------------------------------------------------------------------


def fold_plan(shape: tuple[int, ...]) -> tuple[tuple[int, ...], list[tuple[int, ...]]]:
    """(view_shape, groups): the `selector._fold_ndim` fold as a plan,
    groups[i] listing the ORIGINAL dims merged into view dim i. Ranks above
    3 fold their leading axes into view dim 0 (never below 3-D); a leading
    dim shorter than a 4-wide block merges into the next."""
    dims = list(shape)
    groups: list[tuple[int, ...]] = [(d,) for d in range(len(dims))]
    if len(dims) > 3:
        groups = [tuple(range(len(dims) - 2)), (len(dims) - 2,), (len(dims) - 1,)]
        dims = [math.prod(shape[:-2])] + list(shape[-2:])
    size = math.prod(shape) if shape else 0
    while len(dims) > 1 and dims[0] < 4 and size:
        groups = [groups[0] + groups[1]] + groups[2:]
        dims = [dims[0] * dims[1]] + dims[2:]
    return tuple(dims), groups


@dataclass(frozen=True)
class ShardSeg:
    """One unique data shard of a field's folded view (replicas share it)."""

    start: tuple[int, ...]  # view coords
    stop: tuple[int, ...]
    devices: tuple[int, ...]  # the replica group's ranks, ascending


@dataclass(frozen=True, eq=False)
class FieldLayout:
    """How a field's folded global view maps onto mesh shards."""

    mesh: Any
    view_shape: tuple[int, ...]
    local_view: tuple[int, ...]  # uniform shard extent, view coords
    axis_of_dim: tuple[str | None, ...]  # mesh dim splitting each view dim
    orig_spec: tuple  # spec entries over the ORIGINAL dims
    segs: tuple[ShardSeg, ...]


def analyze(x: Any) -> FieldLayout | None:
    """The engine-eligible layout of `x`, or None (the gather path).

    Eligible: a DTensor of Shard/Replicate placements on a mesh that spans
    the job; each sharded dim split by exactly one mesh dim; folding merges
    only unsharded dims (except the leading one); every sharded view dim
    splits evenly into shards that are multiples of the 4-wide block."""
    mesh = rsh.mesh_of(x)
    if mesh is None or x.ndim == 0:
        return None
    if int(mesh.mesh.numel()) != dist.process_count():
        raise ValueError(
            f"a mesh of {int(mesh.mesh.numel())} ranks in a job of "
            f"{dist.process_count()}: the engine's collectives span the whole job"
        )
    shape = tuple(int(s) for s in x.shape)
    spec = rsh.spec_entries(x)
    view_shape, fold_groups = fold_plan(shape)
    axis_of_dim: list[str | None] = []
    for vdim, group in enumerate(fold_groups):
        sharded = [d for d in group if spec[d] is not None]
        if not sharded:
            axis_of_dim.append(None)
            continue
        if sharded != [group[0]]:
            return None  # a merged inner dim is sharded: slices interleave
        entry = spec[group[0]]
        if not isinstance(entry, str):
            return None  # one dim over several mesh dims
        n = rsh.axis_size(mesh, entry)
        if n > 1:
            if shape[group[0]] % n:
                return None  # uneven shards
            local = view_shape[vdim] // n
            if local % 4 or local < 4:
                return None  # a shard boundary would split a 4-block
        axis_of_dim.append(entry if n > 1 else None)
    local_view = tuple(
        v // (rsh.axis_size(mesh, a) if a else 1) for v, a in zip(view_shape, axis_of_dim)
    )
    inner = {g[0]: math.prod(shape[d] for d in g[1:]) for g in fold_groups}
    lead = {g[0]: vd for vd, g in enumerate(fold_groups)}
    segs = []
    for start_o, stop_o, ranks in rsh.unique_shards(x):
        start_v = [0] * len(view_shape)
        stop_v = list(view_shape)
        for d, vd in lead.items():
            start_v[vd] = start_o[d] * inner[d]
            stop_v[vd] = start_v[vd] + (stop_o[d] - start_o[d]) * inner[d]
        segs.append(ShardSeg(tuple(start_v), tuple(stop_v), ranks))
    return FieldLayout(mesh, view_shape, local_view, tuple(axis_of_dim), tuple(spec), tuple(segs))


# ---------------------------------------------------------------------------
# Block ownership: partition the global sample lattice across shards
# ---------------------------------------------------------------------------


def _owned_starts(layout: FieldLayout, starts: np.ndarray) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """rank -> (local starts in the halo-extended local array, global slot
    indices), int64. A block belongs to the shard containing it (shard
    boundaries are 4-aligned); within a replica group, blocks go
    round-robin over the ranks in slot order. The prepended halo plane
    shifts everything by +1, so the 5-wide window of global block `g`
    starts at `g - seg.start`."""
    starts = np.asarray(starts, np.int64).reshape(-1, len(layout.view_shape))
    n = len(starts)
    sharded = [d for d, a in enumerate(layout.axis_of_dim) if a]
    nshard = [layout.view_shape[d] // layout.local_view[d] for d in sharded]
    # each block's shard, as a row-major index over the sharded dims (the
    # order `unique_shards` sorts the segments in)
    key = np.zeros(n, np.int64)
    for d, m in zip(sharded, nshard):
        key = key * m + starts[:, d] // layout.local_view[d]
    seg_key = np.zeros(len(layout.segs), np.int64)
    for d, m in zip(sharded, nshard):
        seg_key = seg_key * m + np.asarray([s.start[d] for s in layout.segs]) // layout.local_view[d]
    seg_of = np.empty(int(seg_key.max()) + 1 if len(seg_key) else 0, np.int64)
    seg_of[seg_key] = np.arange(len(layout.segs))
    seg = seg_of[key] if n else np.zeros(0, np.int64)
    # round-robin position within each shard, in slot order
    order = np.argsort(seg, kind="stable")
    first = np.r_[0, np.flatnonzero(np.diff(seg[order])) + 1] if n else np.zeros(0, np.int64)
    runs = np.diff(np.r_[first, n])
    j = np.empty(n, np.int64)
    j[order] = np.arange(n) - np.repeat(first, runs)
    reps = np.asarray([s.devices for s in layout.segs], np.int64)
    owner = reps[seg, j % reps.shape[1]] if n else np.zeros(0, np.int64)
    seg_start = np.asarray([s.start for s in layout.segs], np.int64)
    local = starts - (seg_start[seg] if n else 0)
    owned = {int(r): (np.zeros((0, starts.shape[1]), np.int64), np.zeros(0, np.int64))
             for r in np.unique(reps)}
    for r in owned:
        mine = owner == r
        owned[r] = (local[mine], np.flatnonzero(mine))
    return owned


# ---------------------------------------------------------------------------
# The shard-local bodies
# ---------------------------------------------------------------------------


def _halo_extend(v: torch.Tensor, axis_of_dim: tuple, mesh) -> torch.Tensor:
    """Prepend one halo plane per view dim: the previous shard's trailing
    plane along sharded dims (`dist.halo`; index-0 shards receive zeros, the
    global-boundary convention), zeros along unsharded dims. Dim by dim, so
    corner halos compose through the already-extended planes."""
    me = dist.process_index()
    for dim, ax in enumerate(axis_of_dim):
        if ax is not None and rsh.axis_size(mesh, ax) > 1:
            prev, nxt = rsh.neighbors(mesh, ax, me)
            recv = dist.halo(v.narrow(dim, v.shape[dim] - 1, 1), prev, nxt)
        else:
            recv = v.new_zeros(v.shape[:dim] + (1,) + v.shape[dim + 1 :])
        v = torch.cat([recv, v], dim=dim)
    return v


def _gather_ext(ext: torch.Tensor, lst: np.ndarray) -> torch.Tensor:
    """(m, 5, ..) halo blocks of the extended local array at `lst` starts."""
    nd = ext.ndim
    m = len(lst)
    st = torch.as_tensor(np.asarray(lst, np.int64).reshape(m, nd), device=ext.device)
    offs = torch.arange(5, device=ext.device)
    bidx = []
    for d in range(nd):
        i = torch.clamp(st[:, d][:, None] + offs[None, :], 0, ext.shape[d] - 1)
        sh = [m] + [1] * nd
        sh[1 + d] = 5
        bidx.append(i.reshape(sh))
    return ext[tuple(bidx)]


def _zfp_partials(halo: torch.Tensor, eb: float, vr: float, nd: int, transform: str):
    """This rank's §5 ZFP statistics of its owned blocks: (exact coder bits,
    EC-point truncation error energy over vr^2, blocks), as in the
    reference's `_field_stats`."""
    f32 = dict(dtype=torch.float32, device=halo.device)
    nohalo = halo[(slice(None),) + (slice(1, None),) * nd]
    n_s = nohalo.shape[0]
    if n_s == 0:
        return 0, torch.zeros((), **f32), 0
    norm, e = align_blocks(nohalo)
    coeffs = block_transform_nd(norm, bot_matrix(transform), nd)
    step = plane_step(torch.tensor(eb, **f32), e, bot_linf_gain(transform) ** nd)
    bits = int(exact_coder_bits_blocks(coeffs, step).to(torch.int64).sum())
    sel_pts = torch.as_tensor(np.flatnonzero(est._ec_point_mask(nd).reshape(-1)), device=halo.device)
    s_ = step.reshape(-1, 1).to(torch.float32)
    co = coeffs.reshape(n_s, -1)[:, sel_pts]
    mt = torch.trunc(co.abs() / s_)
    rec = torch.sign(co) * torch.where(mt > 0, (mt + 0.5) * s_, torch.zeros_like(mt))
    scale = _exp2(e).reshape(-1, 1)
    vr32 = torch.clamp_min(torch.tensor(vr, **f32), 1e-30)
    err2n_blk = est._point_energy((co - rec) * scale) / torch.square(vr32)
    return bits, torch.sum(err2n_blk), n_s


def _sz_partials(halo: torch.Tensor, eb_sz: torch.Tensor, nd: int) -> torch.Tensor:
    """This rank's §4 SZ statistics of its owned blocks at bin 2 * eb_sz:
    the integer-Lorenzo residual bin counts, with the escape count
    appended (int64, PDF_BINS + 1)."""
    half = (est.PDF_BINS - 1) // 2
    out = torch.zeros(est.PDF_BINS + 1, dtype=torch.int64, device=halo.device)
    if halo.shape[0] == 0:
        return out
    d = torch.round(halo / (2.0 * eb_sz.to(halo.device)))
    for ax in range(1, nd + 1):
        n = d.shape[ax]
        d = d.narrow(ax, 1, n - 1) - d.narrow(ax, 0, n - 1)
    k_raw = d.reshape(-1)
    out[est.PDF_BINS] = (k_raw.abs() > half).sum()
    k = (torch.clamp(k_raw, -half, half) + half).to(torch.int64)
    out[: est.PDF_BINS] = torch.bincount(k, minlength=est.PDF_BINS)
    return out


def _stats_decisions(halos, ebs, vrs, sizes, nds, transform):
    """The ``stats`` reconciliation for one engine group: every field's ZFP
    partials, one merge, the iso-PSNR SZ bound, every field's SZ bin
    counts, one merge, then Algorithm 1's formulas on the merged statistics
    (float32, on the host, identical on every rank). Returns per field
    (br_sz, br_zfp, psnr, eb_sz) as Python floats."""
    zfp = [_zfp_partials(h, eb, vr, nd, transform) for h, eb, vr, nd in zip(halos, ebs, vrs, nds)]
    ints = dist.psum(torch.tensor([[b, n] for b, _, n in zfp], dtype=torch.int64).reshape(-1, 2))
    err2 = dist.psum(torch.stack([e.cpu() for _, e, _ in zfp]).reshape(-1))
    f32 = torch.float32
    eb_szs, rows = [], []
    for k, (eb, vr, nd) in enumerate(zip(ebs, vrs, nds)):
        bits, nblk = ints[k, 0].to(f32), ints[k, 1].to(f32)
        bsz = 4**nd
        n_pts = int(est._ec_point_mask(nd).sum())
        br_zfp = bits / torch.clamp_min(nblk * bsz, 1.0)
        mse_over_vr2 = err2[k] / torch.clamp_min(nblk * n_pts, 1.0)
        psnr = est._neg10_log10(mse_over_vr2)
        eb_t = torch.tensor(eb, dtype=f32)
        delta = est.sz_delta_for_psnr(psnr, torch.tensor(vr, dtype=f32))
        eb_sz = torch.minimum(torch.maximum(delta / 2.0, eb_t * 1e-6), eb_t)
        eb_szs.append(eb_sz)
        rows.append((br_zfp, psnr))
    hists = dist.psum(torch.stack([
        _sz_partials(h, eb_sz, nd).cpu() for h, eb_sz, nd in zip(halos, eb_szs, nds)
    ]))
    out = []
    for k, ((br_zfp, psnr), eb_sz, size) in enumerate(zip(rows, eb_szs, sizes)):
        hist, esc = hists[k, : est.PDF_BINS], hists[k, est.PDF_BINS]
        ofrac = esc.to(f32) / torch.clamp_min(hist.sum(), 1).to(f32)
        br_sz = est.sz_bitrate_from_hist(hist, ofrac, float(size))
        out.append((float(br_sz), float(br_zfp), float(psnr), float(eb_sz)))
    return out


def _reduce_moments(xs: list, layouts: list, moments: bool) -> list[tuple]:
    """Per field, the global (min, max) of the float32 view, and with
    `moments` also (mean, mean of squares), from the local shards: every
    rank's partials gathered and combined in rank order (min and max are
    order-free; each unique shard's sums count once, by its lowest rank),
    so every rank derives the same values without a gather of the field."""
    me = dist.process_index()
    parts = []
    for x, lay in zip(xs, layouts):
        v = x.to_local().to(torch.float32)
        owner = next(s.devices[0] for s in lay.segs if me in s.devices) == me
        vd = v.double()
        s1 = float(vd.sum()) if owner else 0.0
        s2 = float((vd * vd).sum()) if owner else 0.0
        parts.append([float(v.amin()), float(v.amax()), s1, s2])
    allp = dist.all_gather(torch.tensor(parts, dtype=torch.float64).reshape(-1, 4)).numpy()
    out = []
    for k, x in enumerate(xs):
        lo = np.float32(np.min(allp[:, k, 0]))
        hi = np.float32(np.max(allp[:, k, 1]))
        if not moments:
            out.append((float(lo), float(hi)))
            continue
        size = float(x.numel())
        s1 = float(dist.sum_in_rank_order(torch.from_numpy(allp[:, k, 2])))
        s2 = float(dist.sum_in_rank_order(torch.from_numpy(allp[:, k, 3])))
        out.append((float(lo), float(hi), float(np.float32(s1 / size)), float(np.float32(s2 / size))))
    return out


def _moments_fingerprint(
    view_shape: tuple[int, ...], vr: float, size: int,
    lo: float, hi: float, mean: float, msq: float, r_sp: float,
) -> dict:
    """Fingerprint record of an engine-eligible field, from its global value
    moments (DESIGN.md §8): a hit certifies the global min/max/mean/mean
    of squares and the sample grid are unchanged, not the bytes; a replayed
    decision still honours the policy's pointwise bound on the current
    data, so drift past the moments costs only rate optimality."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"repro-dc1-moments")
    h.update(np.asarray(view_shape, np.int64).tobytes())
    h.update(np.asarray([vr, float(size), r_sp, lo, hi, mean, msq], np.float64).tobytes())
    return dict(kind="moments", digest=h.hexdigest(), vr=vr, size=int(size),
                smin=lo, smax=hi, mean=mean, msq=msq)


# ---------------------------------------------------------------------------
# plan_tree: decisions for a whole pytree, shard-locally
# ---------------------------------------------------------------------------


@dataclass
class FieldPlan:
    """One field's reconciled decision and the layout its bytes will ride."""

    selection: Selection
    solution: ctl.TargetSolution | None
    layout: FieldLayout | None  # None -> a single gathered segment
    view_shape: tuple[int, ...]
    reconcile: str  # 'stats' | 'samples' | 'host' | 'degenerate' | 'cached'
    # the host copy `plan_tree` gathered of a DTensor it decided on the
    # gather path (every rank holds it); the writers encode from it rather
    # than gather the field a second time, and drop it once done
    gathered: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def sharded(self) -> bool:
        return self.layout is not None

    @property
    def path(self) -> str:
        """'shard-local' or 'gather': whether the field's bytes stay on
        their shards (decided, or degenerate, without a gather)."""
        return "shard-local" if self.sharded else "gather"


def _shape_shim(view_shape: tuple[int, ...]) -> Any:
    size = math.prod(view_shape) if view_shape else 1
    return SimpleNamespace(ndim=len(view_shape), shape=view_shape, size=size)


def _default_device(arrs: list, device):
    """`device`, else the mesh device of the first DTensor, else the GPU."""
    if device is not None:
        return _device.resolve(device)
    for x in arrs:
        mesh = rsh.mesh_of(x)
        if mesh is not None:
            return rsh.mesh_device(mesh)
    return _device.resolve(None)


def plan_tree(
    arrs: list,
    policy: Policy | str | None = None,
    *,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    target_psnr: float | None = None,
    target_ratio: float | None = None,
    r_sp: float | None = None,
    transform: str = "zfp",
    reconcile: str = "auto",
    cache=None,
    names=None,
    device=None,
) -> list[FieldPlan]:
    """Algorithm 1 (or a §7 target solve) over many possibly-sharded fields
    without gathering any engine-eligible one, under ONE quality `Policy`
    (mixed trees group by policy upstream). Every rank of the job calls it
    with the same fields, in the same order.

    reconcile='auto' takes the ``stats`` merge for fixed_accuracy and the
    sample-block gather (decisions equal to the unsharded ones) for the
    target modes; 'stats' / 'samples' force a strategy for fixed_accuracy
    ('stats' is invalid for the target modes: the §7 secant needs the
    sampled curves). The §7.4 metric modes need no extra collective: their
    statistics come from the same gathered blocks. Fields whose layout the
    engine cannot carry (`analyze`) are gathered and decided on the
    ordinary path, merged into the same batches in input order, so a mixed
    tree decides as the unsharded `select_many` / `solve_many` would.

    `cache`/`names` (a `DecisionCache`): engine-eligible fields fingerprint
    on the merged global value moments, and validated hits skip the engine
    (`reconcile='cached'`); gathered and degenerate fields re-decide.

    `device` is where the deciders run (default: the fields' mesh device,
    else the GPU)."""
    if isinstance(policy, Policy):
        if any(v is not None for v in (eb_abs, eb_rel, target_psnr, target_ratio, r_sp)):
            raise ValueError("pass either a Policy or the legacy kwargs, not both")
    elif policy is None or isinstance(policy, str):
        policy = policy_from_kwargs(
            "plan_tree", mode=policy, eb_abs=eb_abs, eb_rel=eb_rel,
            target_psnr=target_psnr, target_ratio=target_ratio, r_sp=r_sp,
        )
    else:
        raise TypeError(f"expected a Policy (or legacy mode str), got {policy!r}")
    mode, r_sp = policy.mode, policy.r_sp
    eb_abs, eb_rel = policy.eb_abs, policy.eb_rel
    codecs = policy.codecs
    if mode == "raw":
        raise ValueError("plan_tree has nothing to decide for Policy.raw()")
    if mode != "fixed_accuracy":
        if reconcile == "stats":
            raise ValueError("target modes require reconcile='samples'")
        reconcile_eff = "samples"
    else:
        reconcile_eff = "stats" if reconcile in ("auto", "stats") else "samples"
    if mode == "fixed_accuracy":
        target = eb_abs if eb_abs is not None else eb_rel
    else:
        attr = TARGET_FIELD.get(mode)
        if attr is None:
            raise ValueError(
                f"plan_tree cannot solve mode {mode!r}; supported modes: "
                f"fixed_accuracy, {', '.join(TARGET_FIELD)}"
            )
        target = float(getattr(policy, attr))

    arrs = list(arrs)
    n = len(arrs)
    if cache is not None:
        if names is None:
            raise ValueError("plan_tree(cache=...) requires names=")
        names = list(names)
        if len(names) != n:
            raise ValueError(f"names/arrs length mismatch: {len(names)} vs {n}")
    plans: list[FieldPlan | None] = [None] * n
    layouts = [analyze(x) for x in arrs]
    dev = _default_device(arrs, device)
    # one merge of the global min/max for every engine-eligible field
    # (size-0 fields pin vr = 0.0); the warm path widens it to the moments
    vr_of: dict[int, float] = {
        i: 0.0 for i in range(n) if layouts[i] is not None and not arrs[i].numel()
    }
    moments_of: dict[int, tuple[float, float, float, float]] = {}
    elig = [i for i in range(n) if layouts[i] is not None and i not in vr_of]
    if elig:
        red = _reduce_moments([arrs[i] for i in elig], [layouts[i] for i in elig], cache is not None)
        for i, r in zip(elig, red):
            # f32 subtraction first, matching the unsharded path
            vr_of[i] = float(np.float32(r[1]) - np.float32(r[0]))
            if cache is not None:
                moments_of[i] = r

    cache_store: list[tuple[int, str, tuple, str, dict]] = []
    host_idx: list[int] = []
    engine: list[tuple[int, np.ndarray]] = []  # (field index, global starts)
    for i, x in enumerate(arrs):
        lay = layouts[i]
        if lay is None:
            host_idx.append(i)
            continue
        view_shape = lay.view_shape
        vr = vr_of[i]
        # target modes mirror solve_many: no bound hints reach the raw fallback
        deg_eb = (eb_abs, eb_rel) if mode == "fixed_accuracy" else (None, None)
        sel0 = _degenerate_selection(_shape_shim(view_shape), vr, *deg_eb, r_sp)
        if sel0 is not None:
            sol = None
            if mode != "fixed_accuracy":
                sol = ctl.TargetSolution(
                    sel0, mode, float(target), math.inf, ctl.RAW_BITS,
                    mode != "fixed_ratio", est_metric=qual.lossless_metric(mode),
                )
            plans[i] = FieldPlan(sel0, sol, lay, view_shape, "degenerate")
            continue
        starts = est.block_starts(view_shape, r_sp)
        cap = _max_batch_blocks(len(view_shape))
        if len(starts) > cap:
            if mode == "fixed_accuracy":
                host_idx.append(i)  # select_many's monster-field path
                continue
            starts = starts[:: -(-len(starts) // cap)]  # the controller's stride-down
        if cache is not None:
            shape = tuple(int(s) for s in x.shape)
            dtype = _device.dtype_name(x)
            fp = _moments_fingerprint(view_shape, vr, math.prod(view_shape), *moments_of[i], r_sp)
            entry = cache.lookup(names[i], shape, dtype, policy, transform, fp)
            if entry is not None and (mode == "fixed_accuracy" or entry.solution is not None):
                sol = entry.to_solution() if entry.solution is not None else None
                plans[i] = FieldPlan(entry.to_selection(), sol, lay, view_shape, "cached")
                continue
            cache_store.append((i, names[i], shape, dtype, fp))
        engine.append((i, starts))

    blocks_of: dict[int, torch.Tensor] = {}
    if engine:
        # all fields of a job share its ranks; one launch per mesh keeps the
        # collectives in the same order on every rank
        mesh_groups: dict[int, list[tuple[int, np.ndarray]]] = {}
        mesh_of_group: dict[int, Any] = {}
        for i, starts in engine:
            key = id(layouts[i].mesh)
            mesh_of_group[key] = layouts[i].mesh
            mesh_groups.setdefault(key, []).append((i, starts))
        for key, group in mesh_groups.items():
            _plan_engine_group(
                mesh_of_group[key], group, arrs, layouts, vr_of, plans, blocks_of, eb_abs,
                eb_rel, r_sp, transform, reconcile_eff, codecs, dev,
            )

    # Decide everything not yet planned in ONE merged batch run: gathered
    # members go through the helpers `select_many`/`solve_many` use, engine
    # members carry their reassembled blocks, and merging them in input
    # order reproduces the unsharded batch composition exactly. A gather is
    # a collective: every rank makes it, in field order.
    host_arrs = [dist.to_numpy(arrs[i]) if dist.is_dtensor(arrs[i]) else arrs[i] for i in host_idx]
    gathered_of = {i: a for i, a in zip(host_idx, host_arrs) if dist.is_dtensor(arrs[i])}
    if mode == "fixed_accuracy":
        results: list[Selection | None] = [None] * n
        if reconcile_eff == "samples" or host_idx:
            groups = select_mod._build_select_members(
                host_arrs, host_idx, results, eb_abs, eb_rel, r_sp, transform, codecs, dev,
            )
            for i, blocks in blocks_of.items():
                lay = layouts[i]
                eb = float(eb_abs) if eb_abs is not None else float((eb_rel or 0.0) * vr_of[i])
                groups.setdefault(len(lay.view_shape), []).append(
                    (i, blocks, eb, vr_of[i], math.prod(lay.view_shape))
                )
            for nd in groups:
                groups[nd].sort(key=lambda m: m[0])
            _run_select_batches(groups, results, r_sp, transform, codecs)
        for i in host_idx:
            plans[i] = FieldPlan(
                results[i], None, None, _host_view_shape(arrs[i]), "host", gathered_of.get(i)
            )
        for i in blocks_of:
            plans[i] = FieldPlan(results[i], None, layouts[i], layouts[i].view_shape, "samples")
    else:
        results_t: list[ctl.TargetSolution | None] = [None] * n
        groups_t = ctl._build_solve_members(host_arrs, host_idx, results_t, mode, float(target), r_sp, dev)
        for i, blocks in blocks_of.items():
            lay = layouts[i]
            groups_t.setdefault(len(lay.view_shape), []).append(
                ctl._Member(i, blocks, vr_of[i], math.prod(lay.view_shape))
            )
        for nd in groups_t:
            groups_t[nd].sort(key=lambda m: m.idx)
        ctl._solve_groups(
            groups_t, results_t, mode, float(target), ctl.DEFAULT_ROUNDS[mode], r_sp,
            transform, codecs,
        )
        for i in host_idx:
            sol = results_t[i]
            plans[i] = FieldPlan(
                sol.selection, sol, None, _host_view_shape(arrs[i]), "host", gathered_of.get(i)
            )
        for i in blocks_of:
            sol = results_t[i]
            plans[i] = FieldPlan(sol.selection, sol, layouts[i], layouts[i].view_shape, "samples")
    for i, name, shape, dtype, fp in cache_store:
        plan = plans[i]
        cache.store(name, shape, dtype, policy, transform, fp, plan.selection, solution=plan.solution)
    return plans  # type: ignore[return-value]


def _host_view_shape(arr) -> tuple[int, ...]:
    """Folded-view shape without materializing the view (0-d -> (1,))."""
    vs = fold_plan(tuple(int(s) for s in np.shape(arr)))[0]
    return vs if vs else (1,)


def _plan_engine_group(
    mesh,
    group: list[tuple[int, np.ndarray]],
    arrs: list,
    layouts: list,
    vr_of: dict[int, float],
    plans: list,
    blocks_of: dict[int, torch.Tensor],
    eb_abs: float | None,
    eb_rel: float | None,
    r_sp: float,
    transform: str,
    reconcile_eff: str,
    codecs: tuple[str, ...],
    dev: torch.device,
) -> None:
    """One engine pass over the eligible fields of one mesh: each rank's
    owned halo blocks from its local shard; stats mode writes finished
    plans, samples mode leaves the blocks, back in global order, in
    `blocks_of` for the caller's merged batch run."""
    me = dist.process_index()
    halos, owned_of, ebs, vrs, sizes, nds = [], [], [], [], [], []
    for i, starts in group:
        lay: FieldLayout = layouts[i]
        owned = _owned_starts(lay, starts)
        lst, slots = owned.get(me, (np.zeros((0, len(lay.view_shape)), np.int64), np.zeros(0, np.int64)))
        v = arrs[i].to_local().reshape(lay.local_view).to(torch.float32)
        ext = _halo_extend(v, lay.axis_of_dim, mesh)
        halos.append(_gather_ext(ext, lst))
        owned_of.append((i, starts, owned, slots))
        vr = vr_of[i]
        ebs.append(float(eb_abs) if eb_abs is not None else float((eb_rel or 0.0) * vr))
        vrs.append(vr)
        sizes.append(math.prod(lay.view_shape))
        nds.append(len(lay.view_shape))
    if reconcile_eff == "stats":
        stats = _stats_decisions(halos, ebs, vrs, sizes, nds, transform)
        for (i, _, _, _), (br_sz, br_zfp, psnr, eb_sz), eb in zip(owned_of, stats, ebs):
            sel = Selection(
                _pick_codec(br_sz, br_zfp, codecs), float(eb), eb_sz, br_sz, br_zfp, psnr,
                vr_of[i], r_sp,
            )
            plans[i] = FieldPlan(sel, None, layouts[i], layouts[i].view_shape, "stats")
        return
    # samples: every rank's blocks, padded to the largest count, gathered
    # and scattered back into global block order by slot
    for (i, starts, owned, slots), halo in zip(owned_of, halos):
        mx = _next_pow2(max([len(s) for _, s in owned.values()] + [1]))
        pad = mx - halo.shape[0]
        blk = torch.cat([halo, halo.new_zeros((pad,) + tuple(halo.shape[1:]))])
        slt = torch.cat([torch.as_tensor(slots, dtype=torch.int64),
                         torch.full((pad,), -1, dtype=torch.int64)])
        bl = dist.all_gather(blk).reshape((-1,) + tuple(halo.shape[1:])).to(dev)
        sl = dist.all_gather(slt).reshape(-1).to(dev)
        keep = sl >= 0
        out = torch.zeros((len(starts),) + tuple(halo.shape[1:]), dtype=torch.float32, device=dev)
        out[sl[keep]] = bl[keep]
        blocks_of[i] = out


# ---------------------------------------------------------------------------
# Per-shard encoding and segment assembly (Step 4, shard-locally)
# ---------------------------------------------------------------------------


@dataclass
class Segment:
    """One encoded shard of a field: `data` covers view[start:stop]."""

    start: tuple[int, ...]
    stop: tuple[int, ...]
    codec: str
    data: bytes


def _local_device(ranks: tuple) -> int:
    """The replica rank that is THIS process. The segment writer asks only
    for shards it owns (`dist.owner_host`), and the owner holds a replica,
    so this raising means a caller skipped the ownership filter."""
    me = dist.process_index()
    if me in ranks:
        return me
    raise ValueError(
        "no replica of this shard on this process: fetch only segments owned "
        "by this host (dist.owner_host; DESIGN.md §6.2)"
    )


def encode_view_segment(view32, sel: Selection, *, device_encode: bool = False) -> tuple[str, bytes]:
    """Step 4 on one (shard of a) folded float32 view, a tensor (which
    stays on its device for the device encoder) or an array, mirroring
    `selector.encode_with_selection` with its never-bigger-than-raw safety
    net applied per shard. With `device_encode`, codecs that can finish
    Stage III on the device do (K1/K2 for SZ on the card); the host coder
    runs only when the device tier declines."""
    nbytes = 4 * (view32.numel() if isinstance(view32, torch.Tensor) else view32.size)
    if sel.codec == "raw":
        return "raw", _device.to_numpy(view32).tobytes()
    codec = _codecs.get(sel.codec)
    data = None
    if device_encode and getattr(codec, "device_encode", False):
        view_t = view32 if isinstance(view32, torch.Tensor) else torch.from_numpy(view32)
        data = codec.encode_device(view_t, sel)
    if data is None:
        data = codec.encode(_device.to_numpy(view32), sel)
    if len(data) >= nbytes:
        return "raw", _device.to_numpy(view32).tobytes()
    return sel.codec, data


def _view_of(x) -> np.ndarray:
    """The folded float32 host view of a gathered leaf (0-d -> (1,))."""
    arr = x if isinstance(x, np.ndarray) else _device.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    view = _fold_ndim(np.asarray(arr, dtype=np.float32))
    return view.reshape(1) if view.ndim == 0 else view


def encode_plan(x: Any, plan: FieldPlan, host: int | None = None, *,
                device_encode: bool = False, device=None) -> list[Segment]:
    """Encode one field's bytes under its plan: per unique shard when the
    layout allows (each rank touches only the bytes it holds), one gathered
    segment otherwise. Shards reconstruct bit for bit as the whole field
    would: SZ's reconstruction is elementwise and ZFP's 4-block-local with
    4-aligned shard boundaries.

    `host=None` encodes every segment this process holds (all of them on
    one process). With a host index, only the segments that host OWNS: a
    replicated shard is written once, by its lowest rank; a gather-path
    field writes its single segment on host 0 from the copy `plan_tree`
    gathered (`plan.gathered`), or from the array it is handed; with
    `device_encode` its view goes to `device` (default the GPU, so a
    gathered host copy is encoded on the card, not on the CPU)."""
    sel = plan.selection
    if not plan.sharded:
        if host is not None and host != 0:
            return []
        if dist.is_dtensor(x):
            if plan.gathered is not None:
                x = plan.gathered
            elif dist.is_multihost():
                raise ValueError(
                    "encode_plan: gather the field on every rank first (dist.to_numpy)"
                )
            else:
                x = dist.to_numpy(x)
        if device_encode:
            view = _fold_ndim(_device.as_f32(x, _device.resolve(device)))
            view = view.reshape(1) if view.ndim == 0 else view
        else:
            view = _view_of(x)
        codec, data = encode_view_segment(view, sel, device_encode=device_encode)
        return [Segment((0,) * view.ndim, tuple(view.shape), codec, data)]
    me = dist.process_index()
    segs = []
    for s in plan.layout.segs:
        if host is not None and dist.owner_host(s.devices) != host:
            continue
        if host is None and me not in s.devices:
            continue
        local = rsh.shard_data(x, _local_device(s.devices))
        extent = tuple(b - a for a, b in zip(s.start, s.stop))
        view = local.detach().reshape(extent).to(torch.float32)
        codec, data = encode_view_segment(
            view if device_encode else view.cpu().numpy(), sel, device_encode=device_encode
        )
        segs.append(Segment(s.start, s.stop, codec, data))
    return segs


def field_codec(sel_codec: str, segments: list) -> str:
    """The codec to RECORD for a field: the decision, demoted to 'raw' when
    EVERY segment hit the never-bigger-than-raw safety net (as the
    unsharded writer rewrites a field codec). Accepts `Segment`s or bare
    codec strings (the multi-host manifest assembler evaluates it over the
    rows merged from every host)."""
    seg_codecs = [getattr(s, "codec", s) for s in segments]
    if sel_codec != "raw" and seg_codecs and all(c == "raw" for c in seg_codecs):
        return "raw"
    return sel_codec


def decode_segments(view_shape: tuple[int, ...], segments: list[Segment]) -> np.ndarray:
    """Reassemble a field's float32 view from its encoded segments, on the
    host: the elastic-restore core (any mesh, or none, can take the
    result)."""
    out = np.empty(view_shape, np.float32)
    for s in segments:
        extent = tuple(b - a for a, b in zip(s.start, s.stop))
        part = _codecs.get(s.codec).decode(s.data)
        out[tuple(slice(a, b) for a, b in zip(s.start, s.stop))] = part.reshape(extent)
    return out


__all__ = [
    "FieldLayout",
    "FieldPlan",
    "Segment",
    "ShardSeg",
    "analyze",
    "decode_segments",
    "encode_plan",
    "encode_view_segment",
    "field_codec",
    "fold_plan",
    "plan_tree",
]
