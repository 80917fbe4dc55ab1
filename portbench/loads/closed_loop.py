"""One writer in a closed loop on one chip, as a simulation that blocks on
its output step.

Request r sends snapshot r of every field of the configuration, already
on the device (`fields.Snapshots`), through the timed path, waits for the
compressed tree, then makes and sends the next. Set-up is the imports,
the device context, the snapshots' bases, and one warm-up request of
`WARMUP_FIELDS` fields spread over the configuration (snapshot 0): one
more than the program's encoder workers on the card's 8 cores, so every
worker meets the field shape. The window runs whole requests, snapshot
making included, until `seconds` have passed. Under `--trace 1` the spans
are on through the window, and one more request runs under the profiler
after it. Every request's answers go to the check (`oracle`), which runs
once the program's state is freed.

Traffic keys: ``policy`` (a `Policy` spec), ``decide_sample`` (answers the
reference decides again) and ``decode_sample`` (streams the reference
decodes): a check's cost grows with the field's size.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from portbench import harness, oracle, tracing
from portbench.fields import Snapshots

WARMUP_FIELDS = 8


def run(cell, seed: int, seconds: float, trace: bool, *, devices, t0: float,
        log=harness.log, compress=None, shape=None, min_requests: int = 1) -> dict:
    """Run `cell` once. `compress` replaces the timed path (the control and
    the fault tests); `shape` replaces the configuration's field shape
    (tests at a small size); `min_requests` holds the window open for at
    least that many requests."""
    import torch

    from repro_torch.core import api
    from repro_torch.core.device_encode import DECLINES
    from repro_torch.kernels import _build

    if len(devices) != 1:
        raise ValueError(f"{cell.name}: the closed loop runs on one chip, not "
                         f"{len(devices)}; a cell over chips names a load that launches over them")
    device = devices[0]
    t = cell.traffic
    compress = compress or harness.program_compress(device)
    policy = harness.make_policy(t)
    log(f"run: cell {cell.name} seed {seed} seconds {seconds} trace {int(trace)} "
        f"encoder workers {api._default_workers()} (the program's default)")

    def libraries():
        return {k for k in _build.SOURCES if _build.library_path(k).exists()}

    found = libraries()
    t_import = time.perf_counter()
    torch.empty(1, device=device)
    harness.sync(device)
    t_context = time.perf_counter()
    snaps = Snapshots(cell.config, seed, device, shape)
    names = snaps.names
    shapes = {n: snaps.shape for n in names}
    harness.sync(device)
    t_inputs = time.perf_counter()
    k = min(WARMUP_FIELDS, len(names))
    warm = [names[i] for i in sorted({int(round(v)) for v in np.linspace(0, len(names) - 1, k)})]
    compress(snaps.snapshot(0, warm), policy)
    harness.sync(device)
    setup_s = time.perf_counter() - t0
    log(f"setup: {setup_s:.3f} s: imports {t_import - t0:.3f}, device context "
        f"{t_context - t_import:.3f}, snapshot bases {t_inputs - t_context:.3f}, warm-up request "
        f"of {len(warm)} fields {time.perf_counter() - t_inputs:.3f} (kernel libraries found "
        f"built: {sorted(found) or 'none'}; built now: {sorted(libraries() - found) or 'none'})")

    spans = tracing.Spans()
    if trace:
        spans.install()
    ledger = oracle.Ledger(seed=seed, sample=int(t["decode_sample"]),
                           decide=int(t["decide_sample"]))
    declines0 = sum(DECLINES.values())
    attempted = failed = 0
    raw = comp = 0
    codecs: dict[str, int] = {}
    requests = []

    def one(r: int):
        nonlocal attempted, failed
        fields = snaps.snapshot(r)
        attempted += 1
        r0 = time.perf_counter()
        try:
            res = compress(fields, policy)
            harness.sync(device)
        except Exception as exc:  # a request that raises is an answer that never came
            failed += 1
            log("request %d raised:\n%s" % (r, traceback.format_exc()))
            res = exc
        r1 = time.perf_counter()
        del fields
        return res, r0, r1, ledger.record(r, names, res, shapes)

    t_start = time.perf_counter()
    r = 1
    while True:
        res, r0, r1, (r_raw, r_comp, r_codecs) = one(r)
        r += 1
        requests.append((r0, r1))
        raw += r_raw
        comp += r_comp
        for c, n in r_codecs.items():
            codecs[c] = codecs.get(c, 0) + n
        del res
        if r1 - t_start >= seconds and len(requests) >= min_requests:
            break
    window_s = requests[-1][1] - t_start
    declines = sum(DECLINES.values()) - declines0
    lossy = codecs.get("sz", 0) + codecs.get("zfp", 0)
    log(f"window: {len(requests)} requests in {window_s:.3f} s, {raw} raw bytes, {comp} stream "
        f"bytes, {declines} declines, codecs {codecs}; request seconds "
        + " ".join(f"{b - a:.3f}" for a, b in requests))

    device_trace, sz_device = None, 0
    if trace:
        with tracing.profiled(spans) as holder:
            res, r0, r1, _ = one(r)
            spans.add("request", r0, r1)
            if not isinstance(res, BaseException):
                sz_device += sum(cf.codec == "sz" and cf.data[:4] == b"SZJ2"
                                 for cf in res.fields.values())
            del res
        device_trace = holder.trace
        spans.uninstall()

    dev_info = harness.device_info(devices, device_trace)
    # the program's state is gone before the reference runs; the run's own
    # inputs stay to make each judged snapshot again
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = oracle.judge(cell, ledger, snaps, log=log)
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    correct = oracle.passed(checks) and failed == 0

    values = {"compress_GBps": raw / window_s / 1e9 if window_s > 0 else 0.0,
              "ratio": raw / comp if comp else 0.0,
              "setup_s": setup_s}
    ctx = {"requests": _stage_times(requests, spans), "declines": declines,
           "raw_bytes": raw, "window_s": window_s,
           "lossy_fields": lossy, "trace": device_trace,
           "stretch_sz_device_fields": sz_device, "field_shape": snaps.shape}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": harness.metrics(cell, trace, values, ctx), "device": dev_info}
    if device_trace is not None:
        out["breakdown"] = {"device_ops": device_trace.top_ops(),
                            "idle_gaps": device_trace.top_gaps()}
    out["checks"] = checks
    return out


def _stage_times(requests: list, spans: tracing.Spans) -> list[dict]:
    """Per window request: its wall time, the time inside `select_many` and
    `solve_many`, and when (from its start) the last decision span ended."""
    out = []
    for r0, r1 in requests:
        sel = solve = 0.0
        decided = None
        for name, s, e in spans.between(r0, r1):
            if name in ("select_many", "solve_many"):
                if name == "select_many":
                    sel += e - s
                else:
                    solve += e - s
                decided = max(decided or 0.0, e - r0)
        out.append({"wall_s": r1 - r0, "select_s": sel, "solve_s": solve, "decided_s": decided})
    return out
