"""Multi-process job runner: one fresh interpreter per rank.

Port of `repro.launch.mhrun`, on `torch.distributed`. The multi-host
protocol (DESIGN.md §6.2) needs real multi-process jobs, which one pytest
process cannot host (one rank per process). This module spawns N python
workers, each joining one job through `runtime.dist.initialize` with an
explicit backend, runs a named scenario in every worker, and collects
each rank's result and exit code: the machinery behind the port's
multi-process tests, `launch/shardckpt.py --processes` and
`chip_smoke.py --sharded`.

Protocol (a shared filesystem and the job's TCPStore):

* the runner itself holds the job's `TCPStore` as master on a port the OS
  picks (port 0), so two jobs started at once (xdist workers) never race
  for a free port; it writes one `spec.json` (store address and port,
  process count, backend, scenario name and args, output dir) and starts
  `cmd + [spec.json]` once per rank as a fresh `subprocess` (never a fork,
  so no CUDA context is inherited) with ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT`` and ``REPRO_STORE_EXTERNAL=1``;
* `build_kernels=True` builds the CUDA kernels in the runner first, so
  the ranks load one library instead of racing to compile it;
* each worker calls `worker_init(spec_path)` first, runs its scenario and
  reports through `write_result` -> `result.<rank>.json`; an uncaught
  exception becomes ``{"error": ...}`` and exit code 1;
* the runner enforces a hard wall-clock `timeout_s`: a worker still
  running then is killed (its whole process group), so a hung barrier
  fails the job, never the suite. It returns one `HostResult` per rank
  (result None when the worker died before reporting).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import tempfile
import time
from datetime import timedelta
from typing import Any, Sequence


@dataclasses.dataclass
class HostResult:
    """One worker's outcome: exit code, captured stdout+stderr, and the
    payload it reported (None if it died before `write_result`)."""

    process_id: int
    returncode: int
    output: str
    result: dict | None

    @property
    def ok(self) -> bool:
        return self.returncode == 0 and self.result is not None and "error" not in self.result


def run(
    cmd: Sequence[str],
    num_processes: int,
    *,
    scenario: str,
    args: dict | None = None,
    backend: str = "gloo",
    timeout_s: float = 120.0,
    workdir: str | None = None,
    extra_env: dict[str, str] | None = None,
    build_kernels: bool = False,
) -> list[HostResult]:
    """Launch `num_processes` workers of `cmd` as one job over `backend`.

    `cmd` is the worker program (e.g. ``[sys.executable, "-m", mod]``);
    the spec path is appended as its last argument. Workers that outlive
    `timeout_s` are killed."""
    import torch

    if build_kernels:
        from ..kernels import _build

        _build.build()
    wd = workdir or tempfile.mkdtemp(prefix="mhrun_")
    os.makedirs(wd, exist_ok=True)
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, int(num_processes), True, timeout=timedelta(seconds=timeout_s),
        wait_for_workers=False,
    )
    spec = dict(
        master_addr="127.0.0.1", master_port=int(store.port),
        num_processes=int(num_processes), backend=backend, scenario=scenario,
        args=dict(args or {}), outdir=wd,
    )
    spec_path = os.path.join(wd, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)

    procs: list[tuple[int, subprocess.Popen, Any]] = []
    try:
        for rank in range(num_processes):
            env = os.environ.copy()
            env.update(
                RANK=str(rank), WORLD_SIZE=str(num_processes), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(store.port), REPRO_STORE_EXTERNAL="1",
                MHRUN_PROCESS_ID=str(rank),
            )
            env.update(extra_env or {})
            log = open(os.path.join(wd, f"out.{rank}.log"), "w+")
            p = subprocess.Popen(
                list(cmd) + [spec_path], env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True,
            )
            procs.append((rank, p, log))
        deadline = time.monotonic() + timeout_s
        for _, p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        del store

    results: list[HostResult] = []
    for rank, p, log in procs:
        log.seek(0)
        output = log.read()
        log.close()
        payload = None
        rpath = os.path.join(wd, f"result.{rank}.json")
        if os.path.exists(rpath):
            try:
                with open(rpath) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                payload = None
        results.append(HostResult(rank, int(p.returncode), output, payload))
    return results


def require_success(results: list[HostResult]) -> list[dict]:
    """Every rank's payload in rank order, or an AssertionError carrying
    every failed rank's error and the end of its output."""
    bad = [r for r in results if not r.ok]
    if bad:
        msgs = []
        for r in bad:
            err = (r.result or {}).get("error", "<no result file>")
            msgs.append(f"--- rank {r.process_id} exit={r.returncode} error={err}\n{r.output[-4000:]}")
        raise AssertionError(f"{len(bad)}/{len(results)} ranks failed:\n" + "\n".join(msgs))
    return [r.result for r in sorted(results, key=lambda r: r.process_id)]


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def worker_init(spec_path: str) -> tuple[dict, int]:
    """Join the job described by `spec_path` -> (spec, rank)."""
    from ..runtime import dist

    with open(spec_path) as f:
        spec = json.load(f)
    dist.initialize(spec["backend"])
    return spec, dist.process_index()


def write_result(spec: dict, pid: int, payload: dict) -> None:
    """Report this worker's payload atomically (a rename), so the runner
    never reads a half-written file."""
    path = os.path.join(spec["outdir"], f"result.{pid}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(path + ".tmp", path)


def worker_main(spec_path: str, scenarios: dict[str, Any]) -> int:
    """Worker entry point: join, run `spec['scenario']` from `scenarios` (a
    name -> fn(spec, rank) registry), report, leave the job; an exception
    is reported as ``{"error": repr}`` with exit code 1, so the runner
    tells a failed scenario from a vanished process."""
    from ..runtime import dist

    spec, pid = worker_init(spec_path)
    try:
        payload = scenarios[spec["scenario"]](spec, pid) or {}
    except BaseException as e:  # noqa: BLE001 - reported to the runner
        import traceback

        traceback.print_exc()
        write_result(spec, pid, {"error": f"{type(e).__name__}: {e}"})
        return 1
    write_result(spec, pid, payload)
    dist.shutdown()
    return 0


__all__ = ["HostResult", "require_success", "run", "worker_init", "worker_main", "write_result"]
