"""Cell lowering helpers, in torch.

Port of the first function of `repro.launch.dryrun`: `batch_shardings`,
the layout of a batch's leaves on a mesh. The rest of the reference's
module (lowering and compiling a cell, its memory and cost report) is
ROADMAP.md queue A, item 14d.
"""

from __future__ import annotations

import math
from typing import Any

from ..models import nn
from ..runtime import sharding


def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in (mesh.mesh_dim_names or ()))


def batch_shardings(batch_abs: Any, mesh, global_batch: int) -> Any:
    """A `NamedSharding` per leaf of `batch_abs` (nested dicts of anything
    with a `.shape`): the leading (batch) dim over the data dims ('pod',
    'data') when `global_batch` divides by their size, everything else
    replicated."""
    dp = _dp_axes(mesh)
    sizes = sharding.mesh_shape(mesh)
    dp_n = math.prod(sizes[a] for a in dp)
    first = (dp[0] if len(dp) == 1 else dp) if global_batch % dp_n == 0 else None

    def _s(leaf) -> sharding.NamedSharding:
        spec = (first,) + (None,) * (len(leaf.shape) - 1)
        return sharding.NamedSharding(mesh, sharding.spec_to_placements(mesh, spec))

    return nn.tree_map(_s, batch_abs)


__all__ = ["batch_shardings"]
