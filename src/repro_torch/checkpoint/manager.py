"""Fault-tolerant checkpoints with the paper's per-field codec selection.

Port of `repro.checkpoint.manager`. Two layouts, both behind one reader
(manifest v3; the `layout` key picks the reader):

flat (`CheckpointConfig.sharded=False`): leaves are saved whole, so a
restarted job reloads them on any device:

  <dir>/step_000123/
    manifest.json   # version 3, layout "flat": the Policy/PolicySet spec;
                    # the field table (name, codec s_i, shape, dtype,
                    # offset, nbytes, eb, resolved policy, and for a target
                    # mode the `quality` record); the decision cache
    data.bin        # the concatenated per-field streams (codec registry)
  <dir>/LATEST      # atomic pointer to the newest step, written last

segments (`CheckpointConfig.sharded=True`, DESIGN.md §6): the shard-local
engine (`core/sharded.py`) makes every decision from per-shard statistics
merged with a collective (no gather of a DTensor leaf the engine can
carry), and each field is encoded as per-shard segments in per-host files:

  <dir>/step_000123/
    manifest.json        # version 3, layout "segments"; per field: codec,
                         # eb, view_shape, resolved policy and a segment
                         # table [{start, stop, codec, host, offset,
                         # nbytes}] in folded-view coordinates; `hosts`
                         # and per-host `completion` byte counts
    data.<host>.bin      # one per host: its segments, concatenated
    segtable.<host>.json # more than one process: the host's segment rows,
                         # merged into the manifest by host 0
    commit.<host>        # the host's completion marker, written LAST
  <dir>/LATEST

The segment writer is multi-host (DESIGN.md §6.2): one process per rank,
the merged statistics give every rank the same decisions, and each rank
encodes and writes only the shards it owns (`dist.owner_host`: one writer
per replicated shard) into its own `data.<host>.bin`, with its row table
and a `commit.<host>` marker. A bounded barrier
(`CheckpointConfig.barrier_timeout_s`, on the job's store) fences the
write phase: a dead or straggling host FAILS the save on every live host
instead of hanging it (after up to `save_retries` requeues of the write
phase under fresh barrier names). Host 0 then merges the row tables into
one manifest and promotes the step atomically, so a save that dies
mid-flight never publishes. `restore` refuses a segment manifest whose
markers are missing or whose data files are short
(`IncompleteCheckpointError`).

Restore is elastic for both layouts: `restore` reassembles full tensors
from whatever segments exist (on any number of processes), and
`restore_tree(shardings=...)` places each leaf on a target mesh as a
DTensor; in a multi-process job a rank reads and decodes only the
segments its own shards intersect. v1 (no version key), v2 (segments)
and v3 manifests read behind the same `restore`.

With the same tree, policy and host coder (`workers=0`,
`device_encode=False`), a flat save writes the reference's `data.bin`
byte for byte, and each package restores the other's steps of either
layout.

A save groups the lossy leaves by resolved policy and decides each group
in one batched `select_many` or `solve_many` (flat) or one `plan_tree`
(segments) on the manager's device (default the GPU), then encodes the
fields on a `workers`-wide thread pool (with ``device_encode=True``
through the device encoders, K1/K2 for SZ) while a writer drains them in
order. Writes are atomic (a tmp directory, then a rename); the newest
`keep_n` steps are kept, and torn ``.tmp_step_*`` directories older than
the newest step are removed. `async_save` snapshots the tree on the
calling thread (tensors cloned on their device; a sharded save also runs
its decisions, every collective, there) and writes on a worker thread;
`wait` re-raises what the worker raised. With ``cache=True`` (or a
`DecisionCache`) the decisions are carried across saves, persisted in
the manifest, and reloaded by `restore`, so a restarted job's first save
is warm.

With a bare `Policy`, optimizer state (``opt/*``) rides raw; a `PolicySet`
decides every leaf itself. The legacy keyword spelling
(`CheckpointConfig(eb_rel=...)`, `mode=`, ...) maps onto a `Policy` with a
`DeprecationWarning`. Restored leaves are tensors on the manager's device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from .. import device as _device
from ..core import controller, pytree
from ..core import selector as sel
from ..core.api import _is_float
from ..core.decision_cache import DecisionCache
from ..core.policy import (
    TARGET_FIELD,
    Policy,
    PolicySet,
    as_policy_set,
    group_by_policy,
    policy_from_kwargs,
    policy_set_spec,
)
from ..runtime import dist
from ..runtime import sharding as rsh


class IncompleteCheckpointError(RuntimeError):
    """A segment checkpoint is missing per-host completion markers (or its
    data files are shorter than the recorded byte counts): some host's
    write never finished, so the manifest must not be trusted."""


@dataclasses.dataclass
class CheckpointConfig:
    directory: str
    keep_n: int = 3
    # the quality contract: one Policy for every lossy tensor, or a
    # PolicySet resolving one per tensor name (default fixed_accuracy at
    # eb_rel 1e-4)
    policy: Policy | PolicySet | None = None
    compress: bool = True
    workers: int = 4  # thread-pool width of the byte encoders (0 = serial)
    # the shard-local engine (DESIGN.md §6): decisions from per-shard
    # statistics, per-shard segment encoding, segment-layout manifest
    sharded: bool = False
    # cross-step decision cache: False = cold every save; True = a
    # manager-owned `DecisionCache()`; or a configured `DecisionCache`
    cache: Any = False
    # finish Stage III on the device for codecs that can (K1/K2 for SZ);
    # declined fields take the host coder
    device_encode: bool = False
    # the save's fence (DESIGN.md §6.2): how long a host waits at the
    # write/publish barriers before FAILING the save
    barrier_timeout_s: float = 120.0
    # requeues of the write phase after a `BarrierTimeout`, each under a
    # fresh save sequence number (0 disables)
    save_retries: int = 1
    # deprecated keyword spelling (None = unset), mapped onto `policy`
    eb_rel: float | None = None
    r_sp: float | None = None
    mode: str | None = None
    target_psnr: float | None = None
    target_ratio: float | None = None

    def __post_init__(self):
        if isinstance(self.policy, (int, float)):
            # old positional `eb_rel` in the policy slot
            if self.eb_rel is not None:
                raise ValueError("CheckpointConfig: eb_rel given twice")
            self.eb_rel, self.policy = float(self.policy), None
        legacy = (self.eb_rel, self.r_sp, self.mode, self.target_psnr, self.target_ratio)
        if any(v is not None for v in legacy):
            if self.policy is not None:
                raise ValueError(
                    "CheckpointConfig: pass either policy= or the legacy "
                    "quality kwargs, not both"
                )
            self.policy = policy_from_kwargs(
                "CheckpointConfig", mode=self.mode, eb_rel=self.eb_rel,
                target_psnr=self.target_psnr, target_ratio=self.target_ratio,
                r_sp=self.r_sp, default_eb_rel=1e-4, stacklevel=4,
            )
        elif self.policy is None:
            self.policy = Policy.fixed_accuracy()

    @property
    def policy_set(self) -> PolicySet:
        return as_policy_set(self.policy)


def _leaf_items(tree: Any, gather: bool = True) -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf in the reference's order and names
    (`core/pytree.py`): tensors as they are, anything else as a numpy
    array (a Python float a 0-d float64). With `gather`, a DTensor leaf
    is gathered into a host tensor (a collective: every process walks the
    same tree at the same point), which keeps the flat layout usable
    beyond one process."""
    leaves, _ = pytree.flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        if gather and dist.is_dtensor(leaf):
            leaf = dist.gather(leaf)
        elif not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        out.append((pytree.leaf_name(path), leaf))
    return out


#: spec recorded for leaves that ride raw (non-float, lossy-rejected or
#: policy-raw): the v3 row's `policy` key is always present
_RAW_SPEC = {"mode": "raw"}


def _field_policy_spec(pol: Policy | None) -> dict:
    return pol.spec() if pol is not None else dict(_RAW_SPEC)


def _quality_record(sol: Any) -> dict | None:
    """A target-mode row's `quality` key: the resolved target beside what
    the controller estimates it achieved (`est_metric` for the metric
    modes only); None for fixed_accuracy and raw rows."""
    if sol is None:
        return None
    rec = dict(
        mode=sol.mode, target=sol.target, est_psnr=sol.est_psnr,
        est_bitrate=sol.est_bitrate, on_target=sol.on_target,
    )
    if sol.est_metric is not None:
        rec["est_metric"] = sol.est_metric
    return rec


class _HostBlobs:
    """Range reader over a step directory's per-host data files: a host's
    file is opened on first touch and only the spans asked for are read
    (the elastic restore's locality primitive)."""

    def __init__(self, d: str):
        self._d = d
        self._files: dict[int, Any] = {}

    def read(self, host: int, offset: int, nbytes: int) -> bytes:
        f = self._files.get(host)
        if f is None:
            f = self._files[host] = open(os.path.join(self._d, f"data.{host}.bin"), "rb")
        f.seek(offset)
        return f.read(nbytes)

    @property
    def hosts_opened(self) -> list[int]:
        return sorted(self._files)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


def _flat_span(start, stop, shape: tuple[int, ...]) -> tuple[int, int]:
    """Conservative C-order flat element range [lo, hi) bounding the box
    start:stop of an array of `shape`. The fold (`sharded.fold_plan`) only
    merges adjacent dims, so spans in original and folded coordinates index
    the same flat order and compare directly; a span may cover extra
    elements, never fewer."""
    if not shape:
        return 0, 1
    if any(int(b) <= int(a) for a, b in zip(start, stop)):
        return 0, 0
    lo = int(np.ravel_multi_index(tuple(int(a) for a in start), shape))
    hi = int(np.ravel_multi_index(tuple(int(b) - 1 for b in stop), shape)) + 1
    return lo, hi


def _spans_overlap(a: tuple[int, int], b: tuple[int, int]) -> bool:
    return a[0] < b[1] and b[0] < a[1]


def _need_span(sharding: Any, shape: tuple[int, ...]) -> tuple[int, int]:
    """The conservative flat span of the elements THIS process holds under
    a target `sharding` (its shard's box); the whole field without one."""
    if sharding is None:
        return 0, math.prod(shape) if shape else 1
    start, stop = rsh.local_box(sharding, tuple(shape))
    return _flat_span(start, stop, tuple(shape))


def _to_dtype(t: torch.Tensor, like) -> torch.Tensor:
    """`t` in the dtype of template leaf `like` (a tensor or an array)."""
    if isinstance(like, torch.Tensor):
        return t.to(like.dtype)
    if hasattr(like, "dtype"):
        return t.to(_device.torch_dtype(str(like.dtype)))
    return t


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig, *, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        # barrier names must be fresh per save attempt
        self._save_seq = 0
        # BarrierTimeout requeues the last completed save needed
        self.last_save_retries = 0
        # segment locality of the last `restore_tree` of a segment
        # checkpoint: {"segments_decoded", "segments_total", "hosts_opened"}
        self.last_restore_stats: dict | None = None
        cache = cfg.cache
        if cache is True:
            cache = DecisionCache()
        elif cache is False:
            cache = None
        self.cache = cache

    # -- save ---------------------------------------------------------------

    def _default_lossy(self) -> Callable[[str], bool]:
        """With a bare Policy, optimizer state (`opt/*`) defaults to raw;
        with a PolicySet its rules decide every leaf."""
        if isinstance(self.cfg.policy, PolicySet):
            return lambda name: True
        return lambda name: not name.startswith("opt/")

    def _resolve_policies(self, items: list, lossy: Callable[[str], bool]) -> dict[int, Policy]:
        """index -> resolved Policy of every leaf that will compress: float
        (float16/32/64), at least 64 values, accepted by `lossy`, and not
        policy-raw."""
        cfg = self.cfg
        pset = cfg.policy_set
        pol_of: dict[int, Policy] = {}
        for i, (name, leaf) in enumerate(items):
            size = leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size
            if not (cfg.compress and lossy(name) and _is_float(leaf) and size >= 64):
                continue
            pol = pset.resolve(name)
            if pol.mode == "raw":
                continue
            pol_of[i] = pol
        return pol_of

    def _retry_barrier_timeout(self, attempt_fn: Callable[[], str]) -> str:
        """Run a save attempt, requeued up to `cfg.save_retries` times after
        a `BarrierTimeout`; each attempt takes its own `_save_seq`, so its
        barrier names are fresh. The last timeout re-raises.
        `last_save_retries` records the requeues the returning attempt
        needed."""
        retries = max(0, int(self.cfg.save_retries))
        self.last_save_retries = 0
        for attempt in range(retries + 1):
            try:
                return attempt_fn()
            except dist.BarrierTimeout:
                if attempt >= retries:
                    raise
                self.last_save_retries = attempt + 1
        raise AssertionError("unreachable")

    def save(self, step: int, tree: Any, lossy: Callable[[str], bool] | None = None) -> str:
        """Synchronous atomic save. Each tensor's policy comes from
        `cfg.policy`; `lossy(name)` forces names to raw (default: with a
        bare Policy, float leaves under 'opt/' ride raw). With
        `cfg.sharded`, the segment layout through the shard-local engine
        (no gather of a leaf the engine can carry). A save that dies at a
        multi-host barrier is requeued up to `cfg.save_retries` times."""
        if lossy is None:
            lossy = self._default_lossy()
        if self.cfg.sharded:
            return self._save_sharded(step, tree, lossy)
        return self._retry_barrier_timeout(lambda: self._save_flat(step, tree, lossy))

    def _save_flat(self, step: int, tree: Any, lossy: Callable[[str], bool]) -> str:
        """One attempt of the flat writer. Beyond one process, every host
        gathers (a collective) and host 0 alone decides and writes; the
        others wait for the publish barrier."""
        cfg = self.cfg
        final = os.path.join(cfg.directory, f"step_{step:09d}")
        t0 = time.time()
        items = _leaf_items(tree)
        seq = self._save_seq
        self._save_seq += 1
        if dist.process_index() != 0:
            dist.barrier(f"ckpt:{step}:{seq}:published", cfg.barrier_timeout_s)
            return final
        tmp = os.path.join(cfg.directory, f".tmp_step_{step:09d}_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        pol_of = self._resolve_policies(items, lossy)
        # Steps 1-3 of every lossy field in one batched decision per policy
        # group (the solvers move one field at a time to the device and
        # keep only its sampled blocks)
        sel_of: dict[int, sel.Selection] = {}
        sol_of: dict[int, controller.TargetSolution] = {}
        for pol, idxs in group_by_policy(pol_of).items():
            arrs = [items[i][1] for i in idxs]
            names = [items[i][0] for i in idxs] if self.cache is not None else None
            if pol.mode == "fixed_accuracy":
                sels = sel.select_many(
                    arrs, policy=pol, cache=self.cache, names=names, device=self.device
                )
            else:
                sols = controller.solve_many(
                    arrs, pol, cache=self.cache, names=names, device=self.device
                )
                sol_of.update(zip(idxs, sols))
                sels = [s.selection for s in sols]
            sel_of.update(zip(idxs, sels))

        def _encode(i: int) -> tuple[bytes, str, float]:
            _, leaf = items[i]
            s = sel_of.get(i)
            if s is None:
                return _device.raw_bytes(leaf), "none", 0.0
            cf = sel.encode_with_selection(
                leaf, s, device_encode=cfg.device_encode, device=self.device
            )
            return cf.data, cf.codec, s.eb_abs

        fields = []
        with open(os.path.join(tmp, "data.bin"), "wb") as f:
            off = 0
            for i, ((name, leaf), (data, codec, eb)) in enumerate(
                zip(items, self._encoded_in_order(items, _encode))
            ):
                f.write(data)
                row = dict(
                    name=name, codec=codec, shape=[int(s) for s in leaf.shape],
                    dtype=_device.dtype_name(leaf), offset=off, nbytes=len(data), eb=eb,
                    policy=_field_policy_spec(pol_of.get(i)),
                )
                q = _quality_record(sol_of.get(i))
                if q is not None:
                    row["quality"] = q
                fields.append(row)
                off += len(data)
        manifest = self._manifest(step, fields, off, t0, extra=dict(layout="flat"))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        out = self._publish(tmp, final)
        dist.barrier(f"ckpt:{step}:{seq}:published", cfg.barrier_timeout_s)
        return out

    def _encoded_in_order(self, items: list, encode: Callable[[int], Any]):
        """Yield `encode(i)` in input order while a bounded thread pool runs
        ahead of the write cursor: at most `2 * workers` results wait
        encoded but unwritten."""
        cfg = self.cfg
        pool = (
            ThreadPoolExecutor(max_workers=cfg.workers)
            if cfg.workers > 1 and len(items) > 1
            else None
        )
        window = 2 * cfg.workers if pool else 1
        futs: deque = deque()
        nxt = 0
        try:
            for i in range(len(items)):
                if pool is not None:
                    while nxt < len(items) and len(futs) < window:
                        futs.append(pool.submit(encode, nxt))
                        nxt += 1
                    yield futs.popleft().result()
                else:
                    yield encode(i)
        finally:
            if pool is not None:
                pool.shutdown()

    def _manifest(self, step: int, fields: list, total_bytes: int, t0: float,
                  extra: dict) -> dict:
        """The v3 manifest of either layout (`layout` comes in `extra`):
        `policy` records the configured Policy/PolicySet, and the legacy
        `mode`/`target` keys mirror the default policy (a target mode's
        target, else the bound)."""
        default = self.cfg.policy_set.default
        tgt_attr = TARGET_FIELD.get(default.mode)
        man = dict(
            step=step,
            version=3,
            policy=policy_set_spec(self.cfg.policy_set),
            mode=default.mode,
            target=(
                getattr(default, tgt_attr) if tgt_attr is not None
                else default.eb_rel if default.eb_rel is not None
                else default.eb_abs
            ),
            fields=fields,
            total_bytes=total_bytes,
            raw_bytes=int(
                sum(
                    int(np.prod(fl["shape"] or [1])) * _device.itemsize(fl["dtype"])
                    for fl in fields
                )
            ),
            wall_time=time.time(),
            save_seconds=time.time() - t0,
            selection_bits={fl["name"]: fl["codec"] for fl in fields},
        )
        man.update(extra)
        if self.cache is not None:
            # the warm-save state: a restored run reloads these entries and
            # its first save revalidates them
            man["decision_cache"] = self.cache.to_manifest()
        return man

    def _publish(self, tmp: str, final: str) -> str:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        with open(os.path.join(self.cfg.directory, ".LATEST_tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(
            os.path.join(self.cfg.directory, ".LATEST_tmp"),
            os.path.join(self.cfg.directory, "LATEST"),
        )
        self._prune()
        return final

    def _save_sharded(self, step: int, tree: Any, lossy: Callable[[str], bool]) -> str:
        """The segment-layout writer: shard-local decisions (`plan_tree`,
        one pass per policy group), per-shard segment encoding on the
        thread pool, per-host data files. Policy-raw and non-float leaves
        write their exact bytes per shard too (codec ``none``)."""
        t0 = time.time()
        items, pol_of, plan_of = self._plan_sharded(tree, lossy)
        # only the write phase retries: `_plan_sharded` holds the
        # collectives, which must not re-issue out of program order
        return self._retry_barrier_timeout(
            lambda: self._write_sharded(step, t0, items, pol_of, plan_of)
        )

    def _plan_sharded(self, tree: Any, lossy: Callable[[str], bool]):
        """Stage I/II for the segment writer: resolve policies and run the
        shard-local decisions (`plan_tree`, one pass per policy group), then
        hand host 0 the copy `plan_tree` gathered of every field the
        engine could not keep on its shards. It holds every COLLECTIVE of the save, so in a
        multi-process job it runs on the calling thread, in program order,
        on every host; `_write_sharded` (host IO and store barriers) may
        then run on a writer thread (DESIGN.md §6.2)."""
        from ..core import sharded as shd

        items = _leaf_items(tree, gather=False)
        pol_of = self._resolve_policies(items, lossy)
        plan_of: dict[int, Any] = {}
        for pol, idxs in group_by_policy(pol_of).items():
            names = [items[i][0] for i in idxs] if self.cache is not None else None
            plans = shd.plan_tree(
                [items[i][1] for i in idxs], pol, cache=self.cache, names=names,
                device=self.device,
            )
            plan_of.update(zip(idxs, plans))
        # `plan_tree` gathered these fields to every rank already: host 0
        # keeps its copy (`plan.gathered`) for the writer, the others drop it
        if dist.process_index() != 0:
            for plan in plan_of.values():
                plan.gathered = None
        return items, pol_of, plan_of

    def _write_sharded(
        self, step: int, t0: float, items: list, pol_of: dict, plan_of: dict
    ) -> str:
        """Step 4 and publication, per host (DESIGN.md §6.2):

        1. every host encodes the segments it OWNS (`dist.owner_host`:
           one writer per replicated shard; gathered and host-array fields
           on host 0) into `data.<host>.bin`;
        2. it records its rows in `segtable.<host>.json` (more than one
           process) and fsyncs, then writes its `commit.<host>` marker LAST;
        3. a bounded barrier fences the write phase: a dead or straggling
           host raises `BarrierTimeout` on every live host, the tmp dir is
           abandoned, nothing is promoted;
        4. host 0 merges the row tables into the manifest (with `hosts` and
           per-host `completion` byte counts) and promotes atomically; a
           last bounded barrier returns every host only once the step is
           visible."""
        from ..core import sharded as shd

        cfg = self.cfg
        host, nproc = dist.process_index(), dist.process_count()
        seq = self._save_seq
        self._save_seq += 1
        # the hosts of one job share a tmp dir; one process keeps its pid
        tag = "shared" if nproc > 1 else str(os.getpid())
        tmp = os.path.join(cfg.directory, f".tmp_step_{step:09d}_{tag}")
        final = os.path.join(cfg.directory, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        only = host if nproc > 1 else None

        def _encode(i: int):
            """-> (view_shape, decision codec, eb, eb_sz, [(start, stop,
            codec, bytes)]); the recorded field codec (the raw demote over
            every segment) is evaluated where all hosts' rows are seen."""
            _, leaf = items[i]
            plan = plan_of.get(i)
            if plan is not None:
                encoded = shd.encode_plan(
                    leaf, plan, host=only, device_encode=cfg.device_encode, device=self.device
                )
                segs = [(s.start, s.stop, s.codec, s.data) for s in encoded]
                sel_ = plan.selection
                return plan.view_shape, sel_.codec, sel_.eb_abs, sel_.eb_sz, segs
            shape = tuple(int(s) for s in leaf.shape)
            if rsh.mesh_of(leaf) is not None and leaf.ndim > 0:
                segs = [
                    (start, stop, "none",
                     _device.raw_bytes(rsh.shard_data(leaf, shd._local_device(ranks))))
                    for start, stop, ranks in rsh.unique_shards(leaf)
                    if (only is None and host in ranks)
                    or (only is not None and dist.owner_host(ranks) == only)
                ]
            elif only is not None and only != 0:
                segs = []  # replicated everywhere: host 0 writes it
            else:
                val = leaf.to_local() if dist.is_dtensor(leaf) else leaf
                segs = [((0,) * len(shape), shape, "none", _device.raw_bytes(val))]
            return shape, "none", 0.0, 0.0, segs

        fields = []
        with open(os.path.join(tmp, f"data.{host}.bin"), "wb") as f:
            off = 0
            for i, ((name, leaf), (view_shape, sel_codec, eb, eb_sz, segs)) in enumerate(
                zip(items, self._encoded_in_order(items, _encode))
            ):
                rows = []
                for start, stop, seg_codec, data in segs:
                    f.write(data)
                    rows.append(dict(
                        start=list(start), stop=list(stop), codec=seg_codec, host=host,
                        offset=off, nbytes=len(data),
                    ))
                    off += len(data)
                row = dict(
                    name=name, sel_codec=sel_codec, shape=[int(s) for s in leaf.shape],
                    dtype=_device.dtype_name(leaf), view_shape=list(view_shape), eb=eb,
                    eb_sz=eb_sz, segments=rows, policy=_field_policy_spec(pol_of.get(i)),
                )
                plan = plan_of.get(i)
                q = _quality_record(plan.solution if plan is not None else None)
                if q is not None:
                    row["quality"] = q
                fields.append(row)
            if nproc > 1:
                f.flush()
                os.fsync(f.fileno())
        if nproc > 1:
            with open(os.path.join(tmp, f"segtable.{host}.json"), "w") as f:
                json.dump([fl["segments"] for fl in fields], f)
                f.flush()
                os.fsync(f.fileno())
        # the completion marker comes LAST: it certifies this host's data
        # and row table are on disk
        marker = os.path.join(tmp, f"commit.{host}")
        with open(marker + ".tmp", "w") as f:
            json.dump({"nbytes": off, "fields": len(fields)}, f)
            if nproc > 1:
                f.flush()
                os.fsync(f.fileno())
        os.replace(marker + ".tmp", marker)
        dist.barrier(f"ckpt:{step}:{seq}:written", cfg.barrier_timeout_s)
        if host == 0:
            self._assemble_and_publish(step, t0, tmp, final, fields, nproc)
        dist.barrier(f"ckpt:{step}:{seq}:published", cfg.barrier_timeout_s)
        return final

    def _assemble_and_publish(
        self, step: int, t0: float, tmp: str, final: str, fields: list, nproc: int
    ) -> None:
        """Host 0's manifest assembly: check every host's marker, merge the
        row tables (the decisions are the same on every host, so host 0's
        copies stand), evaluate each field's raw demote over the merged
        rows, and promote atomically."""
        from ..core import sharded as shd

        completion: dict[str, int] = {}
        for h in range(nproc):
            marker = os.path.join(tmp, f"commit.{h}")
            if not os.path.exists(marker):  # the write barrier fences this
                raise IncompleteCheckpointError(
                    f"host {h} passed the write barrier without a completion marker ({marker})"
                )
            with open(marker) as f:
                completion[str(h)] = int(json.load(f)["nbytes"])
            if h > 0:
                with open(os.path.join(tmp, f"segtable.{h}.json")) as f:
                    for fl, rows in zip(fields, json.load(f)):
                        fl["segments"].extend(rows)
        total = 0
        for fl in fields:
            fl["segments"].sort(key=lambda r: (tuple(r["start"]), r["host"]))
            fl["nbytes"] = sum(r["nbytes"] for r in fl["segments"])
            fl["codec"] = shd.field_codec(fl.pop("sel_codec"), [r["codec"] for r in fl["segments"]])
            total += fl["nbytes"]
        manifest = self._manifest(
            step, fields, total, t0,
            extra=dict(layout="segments", hosts=list(range(nproc)), completion=completion),
        )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            if nproc > 1:
                f.flush()
                os.fsync(f.fileno())
        self._publish(tmp, final)

    def async_save(self, step: int, tree: Any, **kw) -> threading.Thread:
        """Snapshot now, encode and write on a worker thread. The snapshot
        is taken on the calling thread (`dist.snapshot`: tensors and
        DTensor shards cloned on their device, behind the caller's queued
        work), so a tensor the caller overwrites after this returns is
        saved with the values it had at the call. A sharded save also runs
        its decisions (`_plan_sharded`, every collective) here before
        returning; beyond one process a flat save gathers here. `wait()`
        re-raises whatever the worker raised; on success the returned
        thread carries ``thread.save_result = {"path", "retries"}``."""
        self.wait()
        self._exc = None
        lossy = kw.pop("lossy", None)
        if kw:
            raise TypeError(f"async_save: unexpected kwargs {sorted(kw)}")
        if lossy is None:
            lossy = self._default_lossy()
        leaves, treedef = pytree.flatten_with_path(tree)
        if self.cfg.sharded or not dist.is_multihost():
            snap = pytree.unflatten(treedef, [dist.snapshot(leaf) for _, leaf in leaves])
        else:
            snap = pytree.unflatten(treedef, [dist.gather(leaf) for _, leaf in leaves])
        done = None
        if any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in leaves):
            # the clones are queued on the caller's stream; the worker and
            # its encoder threads may read on others, so they wait for them
            done = torch.cuda.Event()
            done.record()
        if self.cfg.sharded:
            t0 = time.time()
            planned = self._plan_sharded(snap, lossy)
            run = lambda: self._retry_barrier_timeout(  # noqa: E731
                lambda: self._write_sharded(step, t0, *planned)
            )
        else:
            run = lambda: self.save(step, snap, lossy=lossy)  # noqa: E731

        def _run() -> None:
            try:
                if done is not None:
                    done.synchronize()
                path = run()
                thread.save_result = dict(path=path, retries=self.last_save_retries)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._exc = e

        thread = threading.Thread(target=_run, daemon=True)
        thread.save_result = None
        self._thread = thread
        thread.start()
        return thread

    def wait(self) -> None:
        """Join the async save, re-raising whatever it raised: a failed
        checkpoint must fail loudly, not leave a stale LATEST behind."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def _prune(self) -> None:
        steps = sorted(d for d in os.listdir(self.cfg.directory) if d.startswith("step_"))
        for d in steps[: -self.cfg.keep_n]:
            shutil.rmtree(os.path.join(self.cfg.directory, d), ignore_errors=True)
        if not steps:
            return
        # a crash between staging and promotion leaves a `.tmp_step_*`
        # behind; one older than the newest committed step can never be
        # promoted, so it is garbage (one at or above it may be in flight)
        newest = int(steps[-1].split("_")[1])
        for d in os.listdir(self.cfg.directory):
            if not d.startswith(".tmp_step_"):
                continue
            try:
                tmp_step = int(d.split("_")[2])
            except (IndexError, ValueError):
                continue
            if tmp_step < newest:
                shutil.rmtree(os.path.join(self.cfg.directory, d), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> int | None:
        p = os.path.join(self.cfg.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[-1])

    def _resolve_step_dir(self, step: int | None) -> tuple[int, str]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.cfg.directory}")
        return step, os.path.join(self.cfg.directory, f"step_{step:09d}")

    def _load_manifest(self, d: str) -> tuple[dict, str]:
        """Read and vet a step's manifest -> (manifest, layout), and load
        its decision cache into the manager's, so the next save is warm.

        v3 records the layout; v2 is always segments, v1 (no version key)
        always flat. A segment manifest with a `completion` key is checked
        against its per-host markers and data-file sizes: a checkpoint some
        host never finished is REJECTED (`IncompleteCheckpointError`)."""
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        version = int(manifest.get("version", 1))
        layout = manifest.get("layout", "segments" if version == 2 else "flat")
        if layout == "segments" and "completion" in manifest:
            for h in manifest.get("hosts", []):
                if not os.path.exists(os.path.join(d, f"commit.{h}")):
                    raise IncompleteCheckpointError(
                        f"{d}: completion marker commit.{h} is missing: host {h}'s "
                        "write never finished; refusing to decode"
                    )
                want = int(manifest["completion"].get(str(h), 0))
                data = os.path.join(d, f"data.{h}.bin")
                have = os.path.getsize(data) if os.path.exists(data) else -1
                if have < want:
                    raise IncompleteCheckpointError(
                        f"{d}: data.{h}.bin holds {have} bytes but the manifest "
                        f"records {want}: a truncated write"
                    )
        if self.cache is not None and "decision_cache" in manifest:
            # the next save revalidates these entries against fresh
            # fingerprints before trusting any of them
            self.cache.load_manifest(manifest["decision_cache"])
        return manifest, layout

    def restore(self, step: int | None = None) -> tuple[int, dict[str, torch.Tensor]]:
        """(step, {name: tensor on the manager's device}) of the newest step
        or of `step`, either layout, on any number of processes; each leaf
        writeable, in its recorded dtype and shape."""
        step, d = self._resolve_step_dir(step)
        manifest, layout = self._load_manifest(d)
        if layout == "segments":
            return step, {k: v.to(self.device) for k, v in self._restore_v2(d, manifest).items()}
        return step, self._restore_flat(d, manifest)

    def _restore_flat(
        self, d: str, manifest: dict, only: set[str] | None = None
    ) -> dict[str, torch.Tensor]:
        """{name: tensor} of a flat step's `data.bin`; with `only`, just
        those fields are decoded."""
        out: dict[str, torch.Tensor] = {}
        with open(os.path.join(d, "data.bin"), "rb") as f:
            blob = f.read()
        for fl in manifest["fields"]:
            if only is not None and fl["name"] not in only:
                continue
            seg = blob[fl["offset"] : fl["offset"] + fl["nbytes"]]
            shape, dtype = tuple(fl["shape"]), fl["dtype"]
            if fl["codec"] == "none":
                # exact original-dtype bytes (non-float and policy-raw rows)
                t = _device.from_raw_bytes(seg, dtype, shape)
            elif fl["codec"] == "raw":
                # a selection's raw rows hold float32 working-dtype bytes
                arr = np.frombuffer(bytearray(seg), np.float32).reshape(shape)
                t = torch.from_numpy(arr.astype(np.dtype(dtype)))
            else:
                cf = sel.CompressedField(fl["codec"], seg, shape, dtype)
                t = sel.decompress(cf, device=self.device)
            out[fl["name"]] = t.to(self.device)
        return out

    def _restore_v2(
        self, d: str, manifest: dict, need: dict[str, tuple[int, int]] | None = None,
        only: set[str] | None = None,
    ) -> dict[str, torch.Tensor]:
        """The elastic v2/v3 segment reader: paste each field's segments
        into its folded view (decoding lossy ones on the host), then view it
        in the original shape and dtype, as CPU tensors. Works for any
        saving mesh: segments carry their own view coordinates, and each
        row's `host` names the data file it lives in (range reads).

        `need` (the multi-process `restore_tree`) maps a field name to the
        flat element span this process must hold: only the segments that
        overlap it are read and decoded; the rest of the field stays
        unfilled, so such a field may only be consumed shard-wise.
        `last_restore_stats` records the locality achieved. `only` names
        the fields to read (default all)."""
        from ..core import sharded as shd

        blobs = _HostBlobs(d)
        n_total = n_decoded = 0
        out: dict[str, torch.Tensor] = {}
        try:
            for fl in manifest["fields"]:
                if only is not None and fl["name"] not in only:
                    continue
                shape, dtype = tuple(fl["shape"]), fl["dtype"]
                vshape = tuple(fl["view_shape"])
                rows = fl["segments"]
                n_total += len(rows)
                span = need.get(fl["name"]) if need is not None else None
                if span is not None:
                    rows = [sg for sg in rows
                            if _spans_overlap(span, _flat_span(sg["start"], sg["stop"], vshape))]
                n_decoded += len(rows)
                if fl["codec"] == "none":
                    t = torch.empty(vshape, dtype=_device.torch_dtype(dtype))
                    for sg in rows:
                        data = blobs.read(sg["host"], sg["offset"], sg["nbytes"])
                        ext = tuple(b - a for a, b in zip(sg["start"], sg["stop"]))
                        t[tuple(slice(a, b) for a, b in zip(sg["start"], sg["stop"]))] = (
                            _device.from_raw_bytes(data, dtype, ext)
                        )
                    out[fl["name"]] = t.reshape(shape)
                    continue
                segments = [
                    shd.Segment(tuple(sg["start"]), tuple(sg["stop"]), sg["codec"],
                                blobs.read(sg["host"], sg["offset"], sg["nbytes"]))
                    for sg in rows
                ]
                view = shd.decode_segments(vshape, segments)
                out[fl["name"]] = torch.from_numpy(
                    view.reshape(shape).astype(np.dtype(dtype), copy=False)
                )
            self.last_restore_stats = dict(
                segments_total=n_total, segments_decoded=n_decoded,
                hosts_opened=blobs.hosts_opened,
            )
        finally:
            blobs.close()
        return out

    def restore_tree(
        self, template: Any, step: int | None = None, shardings: Any = None
    ) -> tuple[int, Any]:
        """Restore into the structure of `template` (names must match),
        each leaf in the template leaf's dtype, on the manager's device.

        `shardings` (a tree of `runtime.sharding.NamedSharding` matching
        `template`; None entries stay plain tensors) places every leaf on
        a TARGET mesh as a DTensor as it loads: the elastic restore, a
        checkpoint saved at any mesh and host count resuming under any
        other (DESIGN.md §6). Each rank keeps only its own shard; in a
        multi-process job a segment restore also reads and decodes only the
        segments that shard intersects (`last_restore_stats`). Either layout
        decodes only the template's fields."""
        step, d = self._resolve_step_dir(step)
        manifest, layout = self._load_manifest(d)
        leaves, treedef = pytree.flatten_with_path(template)
        names = [pytree.leaf_name(path) for path, _ in leaves]
        shard_list = None if shardings is None else pytree.flatten_up_to(treedef, shardings)
        if layout == "segments":
            need = None
            if shard_list is not None and dist.is_multihost():
                need = {
                    name: _need_span(s, tuple(int(v) for v in leaf.shape))
                    for name, s, (_, leaf) in zip(names, shard_list, leaves)
                }
            flat = self._restore_v2(d, manifest, need=need, only=set(names))
        else:
            flat = self._restore_flat(d, manifest, only=set(names))
        vals = []
        for i, (name, (_, leaf)) in enumerate(zip(names, leaves)):
            t = _to_dtype(flat[name], leaf)
            s = shard_list[i] if shard_list is not None else None
            vals.append(dist.put_global(t, s) if s is not None else t.to(self.device))
        return step, pytree.unflatten(treedef, vals)


__all__ = ["CheckpointConfig", "CheckpointManager", "IncompleteCheckpointError"]
