"""Carrying state across from the reference package.

A compressor has no weights: the state worth carrying is the decision and
the contract. These helpers take plain values (never `repro` objects, so
this package stays free of JAX) and return the port's types:

* `selection_from_reference(d)` — ``dataclasses.asdict`` of a reference
  `Selection` (or any mapping with its fields) -> the port's `Selection`,
  so a reference decision can drive the port's encoders and the streams
  can be compared byte for byte;
* `policy_from_spec(spec)` — a reference `Policy.spec()` dict -> the
  port's `Policy`;
* `target_solution_from_reference(d)` — ``dataclasses.asdict`` of a
  reference `TargetSolution` -> the port's `TargetSolution`, so a
  reference solve can drive the port's encoders;
* `decision_cache_from_manifest(record)` — a reference
  `DecisionCache.to_manifest()` record -> the port's `DecisionCache`.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Mapping

from .controller import TargetSolution
from .decision_cache import DecisionCache
from .policy import Policy
from .selector import Selection

_FLOAT_FIELDS = tuple(f.name for f in fields(Selection) if f.name != "codec")


def selection_from_reference(d: Mapping) -> Selection:
    """The port's `Selection` for a reference decision given as plain values."""
    return Selection(str(d["codec"]), *(float(d[k]) for k in _FLOAT_FIELDS))


def target_solution_from_reference(d: Mapping) -> TargetSolution:
    """The port's `TargetSolution` for a reference solve given as plain
    values (its `selection` a mapping of `Selection` fields)."""
    met = d.get("est_metric")
    return TargetSolution(
        selection=selection_from_reference(d["selection"]),
        mode=str(d["mode"]),
        target=float(d["target"]),
        est_psnr=float(d["est_psnr"]),
        est_bitrate=float(d["est_bitrate"]),
        on_target=bool(d["on_target"]),
        est_metric=None if met is None else float(met),
    )


def policy_from_spec(spec: Mapping) -> Policy:
    """The port's `Policy` for a reference `Policy.spec()` dict."""
    return Policy.from_spec(dict(spec))


def decision_cache_from_manifest(record: Mapping) -> DecisionCache:
    """The port's `DecisionCache` for a reference `DecisionCache.to_manifest()`
    record given as plain JSON values: same tolerance, same entries, so a
    bound the reference solved replays in the port."""
    cache = DecisionCache(tolerance=float(record.get("tolerance", 0.0)))
    cache.load_manifest(dict(record))
    return cache
