"""Checkpoints with the paper's per-field codec selection, on one host.

Port of the flat layout of `repro.checkpoint.manager`. Leaves are saved
whole, so a restarted job reloads them on any device:

  <dir>/step_000123/
    manifest.json   # version 3, layout "flat": the Policy/PolicySet spec;
                    # the field table (name, codec s_i, shape, dtype,
                    # offset, nbytes, eb, resolved policy, and for a target
                    # mode the `quality` record); the decision cache
    data.bin        # the concatenated per-field streams (codec registry)
  <dir>/LATEST      # atomic pointer to the newest step, written last

The files are the reference's: with the same tree, policy and host coder
(`workers=0`, `device_encode=False`) a save writes the reference's
`data.bin` byte for byte, and each package restores the other's steps
(v1 and v3 flat manifests).

A save groups the lossy leaves by resolved policy and decides each group
in one batched `select_many` or `solve_many` on the manager's device
(default the GPU), then encodes the fields on a `workers`-wide thread pool
(with ``device_encode=True`` through the device encoders, K1/K2 for SZ)
while a writer drains them in order. Writes are atomic (a tmp directory,
then a rename); the newest `keep_n` steps are kept, and torn
``.tmp_step_*`` directories older than the newest step are removed.
`async_save` snapshots the tree on the calling thread (tensors cloned on
their device) and writes on a worker thread; `wait` re-raises what the
worker raised. With ``cache=True`` (or a `DecisionCache`) the decisions
are carried across saves (`select_many(cache=)`), persisted in the
manifest, and reloaded by `restore`, so a restarted job's first save is
warm.

With a bare `Policy`, optimizer state (``opt/*``) rides raw; a `PolicySet`
decides every leaf itself. The legacy keyword spelling
(`CheckpointConfig(eb_rel=...)`, `mode=`, ...) maps onto a `Policy` with a
`DeprecationWarning`. Restored leaves are tensors on the manager's device.

Not ported yet (ROADMAP.md queue A, item 14): ``sharded=True``, the
segment layout and its v2/v3 manifests, more than one process, and
`restore_tree(shardings=)`; each raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import json
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


class IncompleteCheckpointError(RuntimeError):
    """A segment checkpoint is missing per-host completion markers (or its
    data files are shorter than the recorded byte counts): some host's
    write never finished, so the manifest must not be trusted."""


def _item14(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the shard-local engine and the segment layout, not yet "
        "ported: ROADMAP.md queue A, item 14"
    )


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
    # the segment layout of the shard-local engine (not ported: raises)
    sharded: bool = False
    # cross-step decision cache: False = cold every save; True = a
    # manager-owned `DecisionCache()`; or a configured `DecisionCache`
    cache: Any = False
    # finish Stage III on the device for codecs that can (K1/K2 for SZ);
    # declined fields take the host coder
    device_encode: bool = False
    # the save's fence: how long a host waits at the publish barrier
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


def _leaf_items(tree: Any) -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf in the reference's order and names
    (`core/pytree.py`): tensors as they are, anything else as a numpy
    array (a Python float a 0-d float64)."""
    leaves, _ = pytree.flatten_with_path(tree)
    return [
        (pytree.leaf_name(path), leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        for path, leaf in leaves
    ]


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


def _to_dtype(t: torch.Tensor, like) -> torch.Tensor:
    """`t` in the dtype of template leaf `like` (a tensor or an array)."""
    if isinstance(like, torch.Tensor):
        return t.to(like.dtype)
    if hasattr(like, "dtype"):
        return t.to(torch.from_numpy(np.zeros(0, like.dtype)).dtype)
    return t


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig, *, device=None):
        if cfg.sharded:
            raise _item14("CheckpointConfig(sharded=True)")
        if dist.is_multihost():
            raise _item14(f"a checkpoint across {dist.process_count()} processes")
        self.cfg = cfg
        self.device = _device.resolve(device)
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None
        # barrier names must be fresh per save attempt
        self._save_seq = 0
        # BarrierTimeout requeues the last completed save needed
        self.last_save_retries = 0
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
        bare Policy, float leaves under 'opt/' ride raw)."""
        if lossy is None:
            lossy = self._default_lossy()
        return self._retry_barrier_timeout(lambda: self._save_flat(step, tree, lossy))

    def _save_flat(self, step: int, tree: Any, lossy: Callable[[str], bool]) -> str:
        """One attempt of the flat writer."""
        cfg = self.cfg
        final = os.path.join(cfg.directory, f"step_{step:09d}")
        t0 = time.time()
        items = _leaf_items(tree)
        seq = self._save_seq
        self._save_seq += 1
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
        manifest = self._manifest(step, fields, off, t0)
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

    def _manifest(self, step: int, fields: list, total_bytes: int, t0: float) -> dict:
        """The v3 flat manifest: `policy` records the configured
        Policy/PolicySet, and the legacy `mode`/`target` keys mirror the
        default policy (a target mode's target, else the bound)."""
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
            layout="flat",
        )
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

    def async_save(self, step: int, tree: Any, **kw) -> threading.Thread:
        """Snapshot now, encode and write on a worker thread. The snapshot
        is taken on the calling thread (`dist.snapshot`: tensors cloned on
        their device, behind the caller's queued work), so a tensor the
        caller overwrites after this returns is saved with the values it had
        at the call. `wait()` re-raises whatever the worker raised; on
        success the returned thread carries
        ``thread.save_result = {"path", "retries"}``."""
        self.wait()
        self._exc = None
        lossy = kw.pop("lossy", None)
        if kw:
            raise TypeError(f"async_save: unexpected kwargs {sorted(kw)}")
        if lossy is None:
            lossy = self._default_lossy()
        leaves, treedef = pytree.flatten_with_path(tree)
        snap = pytree.unflatten(treedef, [dist.snapshot(leaf) for _, leaf in leaves])
        done = None
        if any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in leaves):
            # the clones are queued on the caller's stream; the worker and
            # its encoder threads may read on others, so they wait for them
            done = torch.cuda.Event()
            done.record()

        def _run() -> None:
            try:
                if done is not None:
                    done.synchronize()
                path = self.save(step, snap, lossy=lossy)
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

    def _load_manifest(self, d: str) -> dict:
        """Read a step's manifest (v1: no version key; v3 flat), and load
        its decision cache into the manager's, so the next save is warm."""
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        version = int(manifest.get("version", 1))
        layout = manifest.get("layout", "segments" if version == 2 else "flat")
        if layout != "flat":
            raise _item14(f"restoring a {layout!r} checkpoint (manifest v{version})")
        if self.cache is not None and "decision_cache" in manifest:
            # the next save revalidates these entries against fresh
            # fingerprints before trusting any of them
            self.cache.load_manifest(manifest["decision_cache"])
        return manifest

    def restore(self, step: int | None = None) -> tuple[int, dict[str, torch.Tensor]]:
        """(step, {name: tensor on the manager's device}) of the newest step
        or of `step`; each leaf writeable, in its recorded dtype and shape."""
        step, d = self._resolve_step_dir(step)
        manifest = self._load_manifest(d)
        out: dict[str, torch.Tensor] = {}
        with open(os.path.join(d, "data.bin"), "rb") as f:
            blob = f.read()
        for fl in manifest["fields"]:
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
        return step, out

    def restore_tree(
        self, template: Any, step: int | None = None, shardings: Any = None
    ) -> tuple[int, Any]:
        """Restore into the structure of `template` (names must match),
        each leaf in the template leaf's dtype, on the manager's device."""
        if shardings is not None:
            raise _item14("restore_tree(shardings=...)")
        step, flat = self.restore(step)
        leaves, treedef = pytree.flatten_with_path(template)
        vals = [_to_dtype(flat[pytree.leaf_name(path)], leaf) for path, leaf in leaves]
        return step, pytree.unflatten(treedef, vals)


__all__ = ["CheckpointConfig", "CheckpointManager", "IncompleteCheckpointError"]
