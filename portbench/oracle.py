"""The comparison that decides `correct`: what every cell's check shares.

Every answer of a run is one field of one request: its codec, its bounds,
its estimated rates and its stream. The plain reference (`refselect`,
`refcodec`) judges them once the window has closed, on the request's own
snapshot, which the run's inputs make again (`fields.Snapshots.host`).
Two numbers hold for every policy:

* ``missing`` — answers that never came: fields absent from a request's
  result, or requests that raised. Exact: 0.
* ``ratio_gap`` — each result's reported ratio against raw bytes over the
  streams' bytes, relative. Exact: 0.

The policy's own numbers come from ``checks/<mode>.py`` (`spec.Cell.check`),
whose ``numbers(cell, ledger, inputs, log)`` returns them by name.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from . import refcodec


@dataclass
class Answer:
    """One field of one request, as the program returned it."""

    request: int
    name: str
    codec: str
    eb_abs: float
    eb_sz: float
    br_sz: float
    br_zfp: float
    vr: float
    nbytes: int


@dataclass
class Ledger:
    """What the run produced, kept small: every answer's numbers, and the
    streams of a seeded reservoir per request and codec, and of the
    largest stream."""

    seed: int
    sample: int
    decide: int = 0
    answers: list[Answer] = field(default_factory=list)
    missing: int = 0
    ratio_gap: float = 0.0
    _reservoir: dict = field(default_factory=dict)
    _seen: dict = field(default_factory=dict)
    _largest: tuple | None = None
    _rng: np.random.Generator | None = None

    def __post_init__(self):
        self._rng = np.random.default_rng([int(self.seed) % (1 << 63), 7])

    def record(self, request: int, expected: list[str], result, shapes: dict) -> tuple:
        """Take one request's result (a CompressedTree-like object with
        `.fields` and `.ratio`), or the exception it raised; returns the
        request's (raw bytes, stream bytes, fields by codec)."""
        codecs: dict[str, int] = {}
        if isinstance(result, BaseException):
            self.missing += len(expected)
            return 0, 0, codecs
        raw = comp = 0
        for name in expected:
            cf = result.fields.get(name)
            if cf is None or cf.selection is None:
                self.missing += 1
                continue
            sel = cf.selection
            n = len(cf.data)
            self.answers.append(Answer(request, name, cf.codec, float(sel.eb_abs),
                                       float(sel.eb_sz), float(sel.br_sz), float(sel.br_zfp),
                                       float(sel.vr), n))
            raw += 4 * int(np.prod(shapes[name]))
            comp += n
            codecs[cf.codec] = codecs.get(cf.codec, 0) + 1
            self._keep(request, name, cf)
        if comp:
            self.ratio_gap = max(self.ratio_gap, abs(float(result.ratio) - raw / comp) / (raw / comp))
        return raw, comp, codecs

    def _keep(self, request: int, name: str, cf) -> None:
        item = (request, name, cf.codec, cf.data, cf.selection)
        key = (request, cf.codec)
        seen = self._seen.get(key, 0) + 1
        self._seen[key] = seen
        res = self._reservoir.setdefault(key, [])
        if len(res) < self.sample:
            res.append(item)
        else:
            j = int(self._rng.integers(seen))
            if j < self.sample:
                res[j] = item
        if self._largest is None or len(item[3]) > len(self._largest[3]):
            self._largest = item

    def sampled(self) -> list[tuple]:
        """`sample` streams to decode: the largest, then each codec in turn
        (the largest's last), and within a codec each request in turn."""
        out = [self._largest] if self._largest is not None else []
        first = out[0][2] if out else None
        by_codec: dict[str, list] = {}
        for (request, codec) in sorted(self._reservoir, key=lambda k: (k[1] == first, k)):
            by_codec.setdefault(codec, []).append(list(self._reservoir[(request, codec)]))
        turns = []
        for reqs in by_codec.values():
            order = []
            while any(reqs):
                order += [r.pop(0) for r in reqs if r]
            turns.append(order)
        while len(out) < self.sample and any(turns):
            for order in turns:
                if order and len(out) < self.sample:
                    item = order.pop(0)
                    if item[:2] != out[0][:2]:
                        out.append(item)
        return out

    def decided(self) -> list[Answer]:
        """`decide` answers drawn from the seed, taken from each request in
        turn, so that every request has answers in the sample."""
        rng = np.random.default_rng([int(self.seed) % (1 << 63), 9])
        by_req: dict[int, list[Answer]] = {}
        for a in self.answers:
            by_req.setdefault(a.request, []).append(a)
        pools = [[p[i] for i in rng.permutation(len(p))] for _, p in sorted(by_req.items())]
        out: list[Answer] = []
        while len(out) < self.decide and any(pools):
            for pool in pools:
                if pool and len(out) < self.decide:
                    out.append(pool.pop(0))
        return out


def decoded(ledger: Ledger, inputs, log=print):
    """Each sampled stream decoded by the reference: yields (request, name,
    codec, selection, x, |x - y| in float64), with |x - y| None where the
    stream does not decode (it says the wrong thing)."""
    for request, name, codec, data, sel in ledger.sampled():
        x = inputs.host(request, name)
        t0 = time.perf_counter()
        try:
            y = refcodec.decode(codec, data, x.shape)
        except Exception as exc:
            log(f"check: request {request} field {name} ({codec}) does not decode: {exc!r}")
            yield request, name, codec, sel, x, None
            continue
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        log(f"check: request {request} field {name} ({codec}, {len(data)} B) decoded in "
            f"{time.perf_counter() - t0:.3f} s")
        yield request, name, codec, sel, x, diff


def value_range(x: np.ndarray) -> float:
    return float(np.float64(x.max()) - np.float64(x.min()))


def codec_bound(codec: str, sel) -> float:
    """The bound the chosen codec promises: SZ's own (at or below the
    user's), ZFP's the user's."""
    return float(sel.eb_sz) if codec == "sz" else float(sel.eb_abs)


def judge(cell, ledger: Ledger, inputs, log=print) -> dict[str, dict]:
    """Each compared number with its limit: {name: {"value", "limit"}}."""
    nums: dict[str, float] = {"missing": float(ledger.missing), "ratio_gap": ledger.ratio_gap}
    nums.update(cell.check.numbers(cell, ledger, inputs, log))
    out = {}
    for name, value in nums.items():
        if name not in cell.limits:
            raise KeyError(f"limits/{cell.name}.json has no limit for {name!r}")
        out[name] = {"value": value, "limit": float(cell.limits[name])}
    return out


def passed(checks: dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
