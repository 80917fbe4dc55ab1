"""Cross-step decision cache — the warm save path (DESIGN.md §8).

Port of `repro.core.decision_cache`. Successive saves of near-identical
data keep each field's decided `Selection` (and, for the target modes, the
solved `TargetSolution`) from the previous save instead of re-running the
estimator. An entry is keyed by the tuple the decision is a pure function
of:

    (field name, original shape, original dtype, Policy.spec(), transform)

and guarded by a fingerprint dict: a content digest (the statistical
predictor's `predictor.fingerprint_of` over the sampled halo blocks, or the
serving tier's `kvcomp._page_fingerprint`) and, optionally, moments. With the
default ``tolerance=0.0`` an entry validates only on digest equality, so
a hit is exactly the decision the cold path would recompute;
``tolerance > 0`` also accepts moment drift within a relative band.

Any change to shape, dtype, policy or transform misses the key; any
content drift beyond tolerance fails the fingerprint. Every lookup outcome
lands in `events` and in the hit/miss/invalidation counters.
`to_manifest` / `load_manifest` round-trip the cache through JSON (floats
survive exactly), in the reference's record layout, so a manifest written
by either package loads in the other (`interop.decision_cache_from_manifest`).
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import asdict, dataclass

from .controller import TargetSolution
from .policy import Policy
from .selector import Selection

#: fingerprint moment keys compared under ``tolerance > 0``, by
#: fingerprint kind (relative drift, each against its previous magnitude
#: floored by _TOL_FLOOR). 'blocks' fingerprints (host/select path) carry
#: residual moments; 'moments' fingerprints (sharded engine) carry the
#: psum-reconciled global value moments.
_MOMENT_KEYS = {
    "blocks": ("vr", "smin", "smax", "ra1", "rv2", "rk4"),
    "moments": ("vr", "smin", "smax", "mean", "msq"),
}
_TOL_FLOOR = 1e-30


def _policy_key(policy: Policy | str) -> str:
    """Canonical JSON of `Policy.spec()` — the manifest-v3 serialization,
    so the key survives the cache's own manifest round-trip."""
    if isinstance(policy, str):
        return policy
    return json.dumps(policy.spec(), sort_keys=True)


@dataclass
class CacheEntry:
    """One field's carried-forward decision + the fingerprint that guards it."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    policy: str              # canonical Policy.spec() JSON
    transform: str
    fingerprint: dict        # content digest (+ moments), by kind
    selection: dict          # Selection fields (dataclass asdict)
    solution: dict | None    # TargetSolution scalars for target modes
    step: int | None = None

    def to_selection(self) -> Selection:
        return Selection(**self.selection)

    def to_solution(self) -> TargetSolution:
        assert self.solution is not None
        return TargetSolution(selection=self.to_selection(), **self.solution)


def _entry_to_json(e: CacheEntry) -> dict:
    d = asdict(e)
    d["shape"] = list(e.shape)
    return d


def _entry_from_json(d: dict) -> CacheEntry:
    d = dict(d)
    d["shape"] = tuple(int(s) for s in d["shape"])
    return CacheEntry(**d)


class DecisionCache:
    """Cross-step per-field decision cache (DESIGN.md §8).

    Thread-safe (one lock around the entry map, so saves may run on a
    worker thread). Counters accumulate until `reset_stats()`;
    `events` holds the LAST lookup outcome per field name, which is what
    hit-rate reports consume.

    ``tolerance=0.0`` (default): entries validate only on fingerprint
    digest equality — warm decisions are bit-identical to cold.
    ``tolerance > 0``: entries additionally validate when every
    fingerprint moment drifted by less than `tolerance` relative to its
    previous value (vr-scale drift for the sample min/max) — more hits on
    slowly-moving fields, decisions possibly one step stale (bounds stay
    guaranteed; see the module docstring).

    ``warm_start=True`` lets the quality-target controller seed its
    secant from an *invalidated* entry's solved bound (`stale`), cutting
    refinement rounds on drifted fields (`solve_many(cache=...)`). Off by
    default: warm-started re-solves can differ from cold solves in ulps,
    and the default contract is bit-identity.
    """

    def __init__(self, tolerance: float = 0.0, warm_start: bool = False):
        if not (tolerance >= 0.0 and math.isfinite(tolerance)):
            raise ValueError(f"tolerance must be finite and >= 0, got {tolerance}")
        self.tolerance = float(tolerance)
        self.warm_start = bool(warm_start)
        self.entries: dict[str, CacheEntry] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.events: dict[str, str] = {}
        self._lock = threading.Lock()

    # -- lookup / store -----------------------------------------------------

    def _key_matches(
        self, e: CacheEntry, shape, dtype: str, pol_key: str, transform: str
    ) -> bool:
        return (
            e.shape == tuple(shape)
            and e.dtype == str(dtype)
            and e.policy == pol_key
            and e.transform == transform
        )

    def _fingerprint_valid(self, old: dict, new: dict) -> bool:
        if old.get("kind") != new.get("kind"):
            return False
        if old.get("digest") == new.get("digest"):
            return True
        if self.tolerance <= 0.0:
            return False
        # moment-drift band: every tracked moment must exist, be finite,
        # and sit within `tolerance` of its previous value. Value-location
        # moments (smin/smax) drift relative to the value range, not to
        # their own (possibly ~0) magnitude.
        keys = _MOMENT_KEYS.get(old.get("kind"))
        if keys is None:
            return False
        vr_scale = max(abs(float(old.get("vr", 0.0))), _TOL_FLOOR)
        for k in keys:
            if k not in old or k not in new:
                return False
            a, b = float(old[k]), float(new[k])
            if not (math.isfinite(a) and math.isfinite(b)):
                return False
            scale = vr_scale if k in ("smin", "smax") else max(abs(a), _TOL_FLOOR)
            if abs(b - a) > self.tolerance * scale:
                return False
        return True

    def lookup(
        self,
        name: str,
        shape,
        dtype: str,
        policy: Policy | str,
        transform: str,
        fingerprint: dict,
    ) -> CacheEntry | None:
        """The previous save's entry for `name` iff key AND fingerprint
        still hold; records the outcome ('hit' / 'miss' / 'invalidated')."""
        pol_key = _policy_key(policy)
        with self._lock:
            e = self.entries.get(name)
            if e is None:
                self.misses += 1
                self.events[name] = "miss"
                return None
            if not self._key_matches(e, shape, dtype, pol_key, transform):
                self.invalidations += 1
                self.events[name] = "invalidated"
                return None
            if not self._fingerprint_valid(e.fingerprint, fingerprint):
                self.invalidations += 1
                self.events[name] = "invalidated"
                return None
            self.hits += 1
            self.events[name] = "hit"
            return e

    def stale(
        self, name: str, shape, dtype: str, policy: Policy | str, transform: str
    ) -> CacheEntry | None:
        """The key-matching entry REGARDLESS of fingerprint — warm-start
        seed material for the §7 secant, never decision material."""
        pol_key = _policy_key(policy)
        with self._lock:
            e = self.entries.get(name)
            if e is not None and self._key_matches(e, shape, dtype, pol_key, transform):
                return e
            return None

    def store(
        self,
        name: str,
        shape,
        dtype: str,
        policy: Policy | str,
        transform: str,
        fingerprint: dict,
        selection: Selection,
        solution: TargetSolution | None = None,
        step: int | None = None,
    ) -> None:
        sol = None
        if solution is not None:
            sol = dict(
                mode=solution.mode, target=solution.target,
                est_psnr=solution.est_psnr, est_bitrate=solution.est_bitrate,
                on_target=solution.on_target, est_metric=solution.est_metric,
            )
        e = CacheEntry(
            name=name, shape=tuple(int(s) for s in shape), dtype=str(dtype),
            policy=_policy_key(policy), transform=transform,
            fingerprint=dict(fingerprint), selection=asdict(selection),
            solution=sol, step=step,
        )
        with self._lock:
            self.entries[name] = e

    # -- telemetry ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            looked = self.hits + self.misses + self.invalidations
            return dict(
                entries=len(self.entries), hits=self.hits, misses=self.misses,
                invalidations=self.invalidations,
                hit_rate=self.hits / looked if looked else 0.0,
            )

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = self.invalidations = 0
            self.events = {}

    def clear(self) -> None:
        with self._lock:
            self.entries = {}

    # -- manifest persistence -----------------------------------------------

    def to_manifest(self) -> dict:
        """JSON-safe record for manifest v3's `decision_cache` key. Floats
        round-trip exactly (json emits repr); inf/nan ride Python json's
        default non-strict handling, which our own readers accept."""
        with self._lock:
            return dict(
                version=1,
                tolerance=self.tolerance,
                entries=[_entry_to_json(e) for e in self.entries.values()],
            )

    def load_manifest(self, record: dict) -> None:
        """Merge a manifest record back in (restored runs resume warm).
        Existing same-name entries are overwritten — the manifest is the
        newer truth at restore time."""
        entries = [_entry_from_json(d) for d in record.get("entries", [])]
        with self._lock:
            for e in entries:
                self.entries[e.name] = e


__all__ = ["CacheEntry", "DecisionCache"]
