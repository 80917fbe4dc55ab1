"""What every load generator shares: the timed path, the policy, the
pieces of the result line, and the look for forbidden modules.

`run_cell` hands a cell to the load generator its traffic file names
(``loads/<load>.py``, `spec.Cell.load`), whose ``run`` sets up,
measures, traces and checks, and returns the result line's object.
"""

from __future__ import annotations

import sys

from .spec import Cell, metric_reader

#: top-level module names that may not be loaded in a measured process: JAX
#: and the JAX package (`repro_torch` starts with `repro`, so names are
#: compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default: loaded)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def make_policy(traffic: dict):
    """The traffic's policy, from its spec (`Policy.from_spec`: a mode and
    that mode's keys, as the program records a policy)."""
    from repro_torch.core.policy import Policy

    return Policy.from_spec(traffic["policy"])


def program_compress(device):
    """The timed path: one request is one `compress_pytree` call with the
    device encoders on and the program's default thread pool."""
    from repro_torch.core import api

    def compress(fields, policy):
        return api.compress_pytree(fields, policy, device_encode=True, device=device)

    return compress


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(devices, trace=None) -> dict:
    """The result line's `device`: the peak is the fullest chip's."""
    import torch

    d0 = devices[0]
    cuda = d0.type == "cuda"
    out = {"platform": "gpu" if cuda else d0.type,
           "kind": torch.cuda.get_device_name(d0) if cuda else "cpu",
           "count": len(devices),
           "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d)) for d in devices)
           if cuda else 0}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def metrics(cell: Cell, trace: bool, values: dict, ctx: dict) -> dict:
    """With `trace` the cell's per-layer metrics, each read by its own
    module from `ctx` and left out where it finds nothing to read; else its
    end-to-end metrics from `values`."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device=None,
             devices=None, t0: float, log=log, **kw) -> dict:
    """Run `cell` once through its load generator and return the result
    line's object. `device` is short for `devices=[device]`; `kw` goes to
    the load generator (the closed loop takes `compress`, `shape`,
    `min_requests`)."""
    devices = list(devices) if devices is not None else [device]
    return cell.load.run(cell, seed, seconds, trace, devices=devices, t0=t0, log=log, **kw)
