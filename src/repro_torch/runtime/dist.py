"""Process-level runtime primitives for the checkpoint manager, one process.

Port of the single-process part of `repro.runtime.dist`: what the flat
checkpoint writer calls, with the reference's single-process behaviour.

* `process_index` / `process_count` / `is_multihost` read
  `torch.distributed` when a process group is up (rank, world size), and
  are 0 / 1 / False otherwise.
* `barrier(name, timeout_s)` is the save protocol's bounded host barrier:
  a no-op on one process. The manager calls it through this module, so a
  test can put a failing barrier in its place and drive the manager's
  `BarrierTimeout` requeue.
* `snapshot(x)` is `async_save`'s copy of a leaf (the reference's
  `to_numpy`): one that later in-place writes to `x` cannot reach; a
  tensor stays on its device.

More than one process (the multi-host segment protocol, its barriers on a
key-value service, and the elastic restore) is ROADMAP.md queue A, item
14: `barrier` raises `NotImplementedError` there.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class BarrierTimeout(RuntimeError):
    """A bounded barrier expired: some host is dead or straggling."""


def _group_up() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def process_index() -> int:
    return int(torch.distributed.get_rank()) if _group_up() else 0


def process_count() -> int:
    return int(torch.distributed.get_world_size()) if _group_up() else 1


def is_multihost() -> bool:
    return process_count() > 1


def _multihost_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} across {process_count()} processes needs the multi-host "
        "protocol, not yet ported: ROADMAP.md queue A, item 14"
    )


def barrier(name: str, timeout_s: float) -> None:
    """Wait until every process reaches `name`, at most `timeout_s` seconds
    (raising `BarrierTimeout` past it). One process: nothing to wait for."""
    if is_multihost():
        raise _multihost_not_ported(f"barrier {name!r}")


def snapshot(x: Any):
    """A copy of one leaf that no later in-place write to `x` reaches: a
    tensor is cloned on its own device (queued on the current stream, so it
    holds the values the caller's earlier work left), an array copied, a
    Python scalar kept as a 0-d array."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x, copy=True)


__all__ = [
    "BarrierTimeout",
    "barrier",
    "is_multihost",
    "process_count",
    "process_index",
    "snapshot",
]
