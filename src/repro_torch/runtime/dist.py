"""Multi-process runtime primitives (DESIGN.md §6.2), on `torch.distributed`.

Port of `repro.runtime.dist`. One process is one rank, and one rank holds
one device; a sharded leaf is a `torch.distributed.tensor.DTensor` on a
`DeviceMesh` with named dims (`runtime/sharding.py`). Everything the
shard-local engine and the multi-host checkpoint protocol need from the
process group sits behind this small surface:

* `initialize(backend, ...)` joins a job from the environment
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) with an
  explicit backend: ``gloo`` or ``nccl``, never picked from what the
  machine has. The job's `TCPStore` is held by rank 0, or by the launcher
  when ``REPRO_STORE_EXTERNAL=1`` (`launch/mhrun.py` holds it, so no two
  jobs race for a port);
* `barrier(name, timeout_s)` is a *bounded* barrier on that store (not a
  device collective, so it is safe from a writer thread): a straggler
  past the deadline raises `BarrierTimeout` on the waiting ranks instead
  of hanging the job; `key_value_set` / `key_value_get` are small
  handshakes on the same store;
* `psum`, `all_gather` and `halo` are the collectives the
  engine calls. Under ``nccl`` the tensors stay on the card; under
  ``gloo`` (which has no send/recv or all-gather for CUDA tensors, and
  the only backend that lets several ranks share one card) each copies
  to the host and back. A float `psum` gathers the per-rank partials and
  adds them in rank order, the order of the reference's CPU `psum`, so
  the sum does not depend on the transport;
* `gather`, `to_numpy`, `put_global`, `replicate`, `device_copy` and `snapshot`
  move leaves between a DTensor and a host array without a DTensor
  redistribution: `gather` pastes the unique shards by their boxes.

One process (no process group, or a group of one) is the identity:
barriers return, collectives hand back their input, `to_numpy` is a host
copy.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Any

import numpy as np
import torch


class BarrierTimeout(RuntimeError):
    """A bounded barrier expired: some host is dead or straggling."""


#: the job's key-value store and the backend it was joined with
_STORE: Any = None
_BACKEND: str | None = None
#: barrier name -> how many times this process has passed it
_BARRIER_GEN: dict[str, int] = {}


def _group_up() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    return int(torch.distributed.get_rank()) if _group_up() else 0


def process_count() -> int:
    return int(torch.distributed.get_world_size()) if _group_up() else 1


def is_multihost() -> bool:
    return process_count() > 1


def backend() -> str | None:
    """The backend this process joined with (None: no process group)."""
    if not _group_up():
        return None
    return _BACKEND or str(torch.distributed.get_backend())


def initialize(
    backend: str,
    *,
    master_addr: str | None = None,
    master_port: int | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout_s: float = 60.0,
) -> None:
    """Join an N-process job with `backend` (``gloo`` or ``nccl``).

    The address, rank and world size default to the environment's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``. Rank 0
    hosts the job's `TCPStore` unless the environment says
    ``REPRO_STORE_EXTERNAL=1`` (a launcher holds it)."""
    global _STORE, _BACKEND
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    env = os.environ
    addr = master_addr or env.get("MASTER_ADDR", "127.0.0.1")
    port = int(master_port if master_port is not None else env["MASTER_PORT"])
    rank = int(rank if rank is not None else env["RANK"])
    world = int(world_size if world_size is not None else env["WORLD_SIZE"])
    store_master = rank == 0 and env.get("REPRO_STORE_EXTERNAL") != "1"
    timeout = timedelta(seconds=timeout_s)
    store = torch.distributed.TCPStore(
        addr, port, world, store_master, timeout=timeout, wait_for_workers=False
    )
    torch.distributed.init_process_group(
        backend, store=torch.distributed.PrefixStore("pg", store), rank=rank,
        world_size=world, timeout=timeout,
    )
    _STORE = torch.distributed.PrefixStore("repro", store)
    _BACKEND = backend


def shutdown() -> None:
    """Leave the job (destroy the process group); a no-op without one."""
    global _STORE, _BACKEND
    if _group_up():
        torch.distributed.destroy_process_group()
    _STORE, _BACKEND = None, None
    _BARRIER_GEN.clear()


def _store():
    if _STORE is None:
        raise RuntimeError("no job store: call dist.initialize(backend) first")
    return _STORE


def _wait(keys: list[str], timeout_s: float, what: str) -> None:
    """Wait for `keys` on the job's store, at most `timeout_s`: past it,
    `BarrierTimeout`; any other store error re-raises as it is."""
    try:
        _store().wait(keys, timedelta(seconds=timeout_s))
    except Exception as e:  # the store raises DistStoreError / RuntimeError
        msg = str(e).lower()
        if "timeout" in msg or "timed out" in msg or "deadline" in msg:
            raise BarrierTimeout(f"{what} timed out after {timeout_s:g}s") from e
        raise


def barrier(name: str, timeout_s: float) -> None:
    """Wait until every process reaches `name`, at most `timeout_s`.

    Each rank writes ``<name>/<pass>/<rank>`` to the job's store (a name
    may be passed again) and waits for all of them, a wait the store
    bounds: past it, `BarrierTimeout` (a dead or straggling host FAILS the
    save instead of hanging it). One process: nothing to wait for."""
    if not is_multihost():
        return
    # every rank passes the same barriers in the same order, so the count of
    # earlier passes of `name` tells them apart without talking
    gen = _BARRIER_GEN.get(name, 0)
    _BARRIER_GEN[name] = gen + 1
    keys = [f"barrier/{name}/{gen}/{r}" for r in range(process_count())]
    _store().set(keys[process_index()], "1")
    _wait(keys, timeout_s, f"barrier {name!r} (a host is dead or straggling)")


def key_value_set(key: str, value: str) -> None:
    _store().set(f"kv/{key}", value)


def key_value_get(key: str, timeout_s: float) -> str:
    """The value some rank set for `key`, waiting at most `timeout_s`."""
    _wait([f"kv/{key}"], timeout_s, f"key {key!r}")
    return _store().get(f"kv/{key}").decode()


# ---------------------------------------------------------------------------
# Collectives the shard-local engine calls
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: itself under nccl, a contiguous host
    copy under gloo."""
    if backend() == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu").contiguous()
    return t.detach().contiguous()


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's `t` stacked in rank order, on `t`'s
    device. Every rank passes the same shape and dtype."""
    if not is_multihost():
        return t.unsqueeze(0)
    src = _staged(t)
    out = [torch.empty_like(src) for _ in range(process_count())]
    torch.distributed.all_gather(out, src)
    return torch.stack(out).to(t.device)


def sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
    """Partials (world, ...) added one rank after another, ((p0 + p1) + p2)
    + ...: the order of the reference's `psum` on its CPU devices."""
    out = parts[0].clone()
    for p in parts[1:]:
        out = out + p
    return out


def psum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over every rank. Integers add exactly (an all-reduce);
    floats are gathered and added in rank order (`sum_in_rank_order`), so
    every transport gives the same bits on every rank."""
    if not is_multihost():
        return t
    if t.dtype.is_floating_point:
        return sum_in_rank_order(all_gather(t))
    src = _staged(t).clone()
    torch.distributed.all_reduce(src, op=torch.distributed.ReduceOp.SUM)
    return src.to(t.device)


def halo(plane: torch.Tensor, prev_rank: int | None, next_rank: int | None) -> torch.Tensor:
    """Send `plane` to `next_rank` and receive the previous rank's plane
    from `prev_rank` (zeros when there is none: the global boundary), the
    one-plane exchange of the Lorenzo halo along a mesh axis."""
    src = _staged(plane)
    buf = torch.zeros_like(src)
    work = []
    if next_rank is not None:
        work.append(torch.distributed.isend(src, next_rank))
    if prev_rank is not None:
        work.append(torch.distributed.irecv(buf, prev_rank))
    for w in work:
        w.wait()
    return buf.to(plane.device)


# ---------------------------------------------------------------------------
# Host copies and placement
# ---------------------------------------------------------------------------


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def spans_processes(mesh) -> bool:
    """True when `mesh` holds more than one rank."""
    return mesh is not None and int(mesh.mesh.numel()) > 1


def owner_host(ranks: tuple) -> int:
    """The process that WRITES a replicated shard: the lowest rank among
    its replicas (`sharding.unique_shards` orders them by rank, so every
    host derives the same owner without talking)."""
    return int(ranks[0])


def gather(x: Any, dst: int | None = None) -> torch.Tensor | None:
    """A host tensor of any leaf, in its dtype, including a DTensor whose
    shards live on other processes: every rank's shard is gathered and the
    unique ones are pasted into the global tensor by their boxes (a
    collective: every rank calls it, in the same order). With `dst`, only
    that rank receives the tensor (the others get None). An array or a
    Python scalar comes back as a tensor of it."""
    if not is_dtensor(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return torch.as_tensor(np.asarray(x))
    from . import sharding as _sh

    local = x.to_local().detach()
    shape = tuple(int(s) for s in x.shape)
    if not is_multihost():
        return local.cpu().reshape(shape)
    # nccl moves device tensors, gloo host ones
    local = (local if backend() == "nccl" else local.cpu()).contiguous()
    shards = _sh.unique_shards(x)
    # every rank sends its shard flattened and padded to the largest extent
    ext = [tuple(b - a for a, b in zip(st, sp)) for st, sp, _ in shards]
    biggest = max(math.prod(e) for e in ext)
    flat = torch.zeros(biggest, dtype=local.dtype, device=local.device)
    flat[: local.numel()] = local.reshape(-1)
    if local.dtype == torch.bfloat16:  # gloo moves integers of its width
        flat = flat.view(torch.int16)
    if dst is None:
        rows = all_gather(flat)
    else:
        parts = [torch.empty_like(flat) for _ in range(process_count())] if process_index() == dst else None
        torch.distributed.gather(flat, parts, dst=dst)
        if process_index() != dst:
            return None
        rows = torch.stack(parts)
    rows = rows.view(local.dtype).cpu()
    out = torch.empty(shape, dtype=local.dtype)
    for (st, sp, ranks), e in zip(shards, ext):
        out[tuple(slice(a, b) for a, b in zip(st, sp))] = rows[ranks[0], : math.prod(e)].reshape(e)
    return out


def to_numpy(x: Any, dst: int | None = None) -> np.ndarray | None:
    """`gather` as a numpy array (a bfloat16 leaf as its int16 bit
    patterns): the multi-process spelling of `np.asarray`."""
    t = gather(x, dst)
    if t is None:
        return None
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def put_global(value, sharding) -> Any:
    """Place `value` (an array, a memory-mapped one included, or a tensor,
    identical on every process) under `sharding` (a
    `runtime.sharding.NamedSharding`): each rank reads only its own box and
    keeps it on the mesh's device, as a DTensor."""
    from torch.distributed.tensor import DTensor

    from . import sharding as _sh

    if not isinstance(value, torch.Tensor):
        value = value if isinstance(value, np.ndarray) else np.asarray(value)
    shape = tuple(int(s) for s in value.shape)
    start, stop = _sh.local_box(sharding, shape)
    box = tuple(slice(a, b) for a, b in zip(start, stop))
    if isinstance(value, torch.Tensor):
        local = value.detach()[box]
    else:
        # only the box is read (a memory-mapped array stays on disk)
        local = torch.from_numpy(np.array(value[box])) if shape else torch.tensor(value[()])
    local = local.to(_sh.mesh_device(sharding.mesh)).contiguous()
    stride = tuple(int(s) for s in torch.empty(shape).stride()) if shape else ()
    return DTensor.from_local(
        local, sharding.mesh, sharding.placements, run_check=False,
        shape=torch.Size(shape), stride=stride,
    )


def replicate(x: Any) -> Any:
    """`x` gathered and placed fully replicated on its own mesh."""
    from torch.distributed.tensor import Replicate

    from . import sharding as _sh

    mesh = x.device_mesh
    return put_global(gather(x), _sh.NamedSharding(mesh, tuple(Replicate() for _ in mesh.mesh.shape)))


def device_copy(x: Any) -> Any:
    """A copy of `x` that later in-place writes to `x` cannot reach, in the
    same layout: a DTensor's local shard cloned on its device."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            x.to_local().detach().clone(), x.device_mesh, x.placements,
            run_check=False, shape=x.shape, stride=x.stride(),
        )
    return snapshot(x)


def snapshot(x: Any):
    """A copy of one leaf that no later in-place write to `x` reaches: a
    tensor is cloned on its own device (queued on the current stream, so it
    holds the values the caller's earlier work left), a DTensor's shard
    likewise, an array copied, a Python scalar kept as a 0-d array."""
    if is_dtensor(x):
        return device_copy(x)
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x, copy=True)


__all__ = [
    "BarrierTimeout",
    "all_gather",
    "backend",
    "barrier",
    "device_copy",
    "gather",
    "halo",
    "is_dtensor",
    "initialize",
    "is_multihost",
    "key_value_get",
    "key_value_set",
    "owner_host",
    "process_count",
    "process_index",
    "psum",
    "put_global",
    "replicate",
    "shutdown",
    "snapshot",
    "spans_processes",
    "sum_in_rank_order",
    "to_numpy",
]
