"""The traced run's instruments: spans around the program's layer entry
points, and the reduction of a `torch.profiler` trace.

The spans wrap, by name, the functions through which the API layer calls
the decision and encode layers. A wrapped name that is missing stops the
run with an error that names it, never a silent zero. They are installed
only under ``--trace 1``.
"""

from __future__ import annotations

import importlib
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

#: (module, attribute, span name): the API layer's calls into each layer
WRAPPED = (
    ("repro_torch.core.api", "select_many", "select_many"),
    ("repro_torch.core.controller", "solve_many", "solve_many"),
    ("repro_torch.core.api", "encode_with_selection", "encode"),
)
#: which span names a host-side gap takes, most specific first
GAP_LABELS = ("select_many", "solve_many", "encode", "request")


@dataclass
class Spans:
    """Host-clock spans (name, start, end) of the wrapped calls."""

    records: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _saved: list = field(default_factory=list)

    def install(self) -> None:
        for mod_name, attr, span in WRAPPED:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                raise AttributeError(f"traced function {mod_name}.{attr} is missing")
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, span))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, fn, span: str):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.add(span, t0, time.perf_counter())

        wrapper.__wrapped__ = fn
        return wrapper

    def add(self, span: str, t0: float, t1: float) -> None:
        with self._lock:
            self.records.append((span, t0, t1))

    def between(self, t0: float, t1: float) -> list:
        with self._lock:
            return [r for r in self.records if r[1] >= t0 and r[2] <= t1]


@dataclass
class DeviceTrace:
    """A traced stretch of requests, reduced: busy seconds (the union of
    device operations), the stretch's length, device seconds by operation
    name, and the idle gaps labelled by the host span they fell in."""

    busy_s: float
    window_s: float
    by_name: dict
    gaps: list

    def top_ops(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.by_name.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.gaps), key=lambda kv: -kv[1])[:n]


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(t: float, host: list) -> str:
    covering = {name for name, s, e in host if s <= t <= e}
    for name in GAP_LABELS:
        if name in covering:
            return name
    return "between_requests"


#: the profiler annotation that bounds the traced stretch
STRETCH = "portbench_stretch"


@contextmanager
def profiled(spans: Spans):
    """Profile the body on the host and the device; yields a holder whose
    `.trace` is the reduced `DeviceTrace` once the body has ended. The
    host spans (taken on any thread, on the host clock) are placed on the
    trace's clock by the stretch annotation's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(STRETCH):
            t_host0 = time.perf_counter()
            yield holder
            torch.cuda.synchronize()
    holder.trace = reduce(prof.events(), spans.between(t_host0, time.perf_counter()), t_host0)


def reduce(events, host: list, t_host0: float) -> DeviceTrace:
    """Busy time, device time by name and labelled idle gaps from the
    profiler's events (microseconds) and the host spans (seconds on the
    host clock, from `t_host0` at the stretch's start)."""
    device, stretch = [], None
    by_name: dict = {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == STRETCH and not str(getattr(e, "device_type", "")).endswith("CUDA"):
            stretch = (s, t)
        elif (str(getattr(e, "device_type", "")).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)
              and e.name != STRETCH and e.name not in GAP_LABELS):
            device.append((s, t))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) * 1e-6
    if stretch is None:
        raise RuntimeError("the profiler recorded no stretch annotation")
    if not device:
        raise RuntimeError("the profiler recorded no device operation in the traced stretch")
    lo, hi = stretch
    host_us = [(name, lo + (a - t_host0) * 1e6, lo + (b - t_host0) * 1e6) for name, a, b in host]
    busy = [[max(s, lo), min(t, hi)] for s, t in _union(device) if t > lo and s < hi]
    gaps, cursor = [], lo
    for s, t in busy + [[hi, hi]]:
        if s > cursor:
            gaps.append((_label((cursor + s) / 2, host_us), (s - cursor) * 1e-6))
        cursor = max(cursor, t)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    return DeviceTrace(busy_s=busy_s, window_s=(hi - lo) * 1e-6, by_name=by_name, gaps=gaps)
