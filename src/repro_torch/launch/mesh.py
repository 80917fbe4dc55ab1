"""Mesh builders over the job's ranks (`torch.distributed.DeviceMesh`).

Port of `repro.launch.mesh`. Functions, not module constants: importing
never touches a process group. One rank is one device; a mesh lays the
job's ranks out row-major over named dims. Building a mesh is a
collective (every rank builds the same meshes in the same order).
"""

from __future__ import annotations

import math

from .. import device as _device
from ..runtime import dist


def make_emulated_mesh(shape=(2, 2), axes=("data", "model"), *, device=None):
    """A `DeviceMesh` of `shape` over the job's ranks in row-major order,
    its dims named `axes`, on `device` (default the GPU). The job must
    have exactly prod(shape) ranks (`launch/mhrun.py` spawns them)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(int(s) for s in shape)
    have = dist.process_count()
    if have != need:
        raise RuntimeError(
            f"make_emulated_mesh{tuple(shape)} needs {need} ranks, the job has {have}; "
            "launch one process per rank (launch/mhrun.py)"
        )
    return init_device_mesh(_device.resolve(device).type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_local_mesh(*, device=None):
    """A (1, 1) ('data', 'model') mesh over a one-rank job."""
    return make_emulated_mesh((1, 1), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ('data', 'model') over 256 ranks; (2, 16, 16) ('pod',
    'data', 'model') over 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_emulated_mesh(shape, axes, device=device)


def describe_mesh(mesh) -> dict:
    """Loggable mesh summary: dims, ranks, this process, the backend."""
    return dict(
        shape={n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)},
        devices=int(mesh.mesh.numel()),
        ranks=[int(r) for r in mesh.mesh.reshape(-1).tolist()],
        device_type=mesh.device_type,
        process_index=dist.process_index(),
        process_count=dist.process_count(),
        backend=dist.backend(),
    )


__all__ = ["describe_mesh", "make_emulated_mesh", "make_local_mesh", "make_production_mesh"]
