"""Policy objects: one quality contract per field.

Port of `repro.core.policy`. A `Policy` is the frozen, validated contract
a caller holds for a field:

    Policy.fixed_accuracy(eb_rel=1e-4)      # the paper's bound-centric mode
    Policy.fixed_psnr(60.0)                 # the target modes, solved by
    Policy.fixed_ratio(8.0)                 #   the quality-target controller
    Policy.fixed_ssim(0.98)                 #   (core/controller.py)
    Policy.fixed_correlation(0.999)
    Policy.fixed_ks(0.05)
    Policy.raw()                            # store verbatim (exact bytes)

plus the estimator sampling rate (`r_sp`) and a codec allowlist (`codecs`,
validated against the registry; `raw` is always available). A `PolicySet`
maps field names to policies with ordered first-match-wins rules (globs,
or regexes with an ``re:`` prefix). `spec` / `from_spec` give the
JSON-safe form the reference records per field (`policy_set_spec` a
whole set's). `group_by_policy` groups a
tree's leaves for batched selection, and `policy_from_kwargs` maps the
deprecated keyword spelling onto a `Policy` with a `DeprecationWarning`.
"""

from __future__ import annotations

import math
import re
import warnings
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Iterable

from . import codecs as _codecs

#: estimator block sampling rate default (the paper's 5%; matches
#: `estimator.DEFAULT_SAMPLING_RATE`)
DEFAULT_R_SP = 0.05
#: the relative bound `Policy.fixed_accuracy()` takes when given none
DEFAULT_EB_REL = 1e-4

MODES = (
    "fixed_accuracy",
    "fixed_psnr",
    "fixed_ratio",
    "fixed_ssim",
    "fixed_correlation",
    "fixed_ks",
    "raw",
)
#: the quality-metric target modes (no legacy keyword spelling)
METRIC_MODES = ("fixed_ssim", "fixed_correlation", "fixed_ks")
#: mode -> the Policy field holding its target, for every target mode
TARGET_FIELD = {
    "fixed_psnr": "target_psnr",
    "fixed_ratio": "target_ratio",
    "fixed_ssim": "target_ssim",
    "fixed_correlation": "target_correlation",
    "fixed_ks": "target_ks",
}


@dataclass(frozen=True)
class Policy:
    """One field's quality contract: mode + target + sampling + codec set.

    Construct through the classmethods (`fixed_accuracy` / `fixed_psnr` /
    `fixed_ratio` / `fixed_ssim` / `fixed_correlation` / `fixed_ks` /
    `raw`) — the bare constructor validates but does not default the
    mode-specific target fields. Frozen and hashable, so policies are
    usable as grouping keys.
    """

    mode: str
    eb_abs: float | None = None
    eb_rel: float | None = None
    target_psnr: float | None = None
    target_ratio: float | None = None
    target_ssim: float | None = None
    target_correlation: float | None = None
    target_ks: float | None = None
    r_sp: float = DEFAULT_R_SP
    codecs: tuple[str, ...] = _codecs.DEFAULT_CODECS

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        # normalize the allowlist: tuple, deduped, raw always available as
        # the degenerate/safety-net fallback
        cods = tuple(dict.fromkeys(self.codecs))
        for name in cods:
            if not _codecs.is_registered(name):
                raise ValueError(
                    f"codec {name!r} is not registered; known: "
                    f"{sorted(_codecs.names())} (core/codecs.py)"
                )
        if "raw" not in cods:
            cods = cods + ("raw",)
        object.__setattr__(self, "codecs", cods)
        if not (0.0 < self.r_sp <= 1.0):
            raise ValueError(f"r_sp must be in (0, 1], got {self.r_sp}")
        if self.mode == "fixed_accuracy":
            if self.eb_abs is None and self.eb_rel is None:
                raise ValueError("fixed_accuracy needs eb_abs or eb_rel")
            for v, n in ((self.eb_abs, "eb_abs"), (self.eb_rel, "eb_rel")):
                if v is not None and not (v > 0 and math.isfinite(v)):
                    raise ValueError(f"{n} must be finite and > 0, got {v}")
        elif self.mode == "fixed_psnr":
            if self.target_psnr is None or not math.isfinite(self.target_psnr):
                raise ValueError("fixed_psnr needs a finite target_psnr (dB)")
        elif self.mode == "fixed_ratio":
            if self.target_ratio is None or not self.target_ratio > 0:
                raise ValueError("fixed_ratio needs target_ratio > 0")
        elif self.mode == "fixed_ssim":
            if self.target_ssim is None or not (0.0 < self.target_ssim < 1.0):
                raise ValueError("fixed_ssim needs target_ssim in (0, 1)")
        elif self.mode == "fixed_correlation":
            if self.target_correlation is None or not (
                0.0 < self.target_correlation < 1.0
            ):
                raise ValueError(
                    "fixed_correlation needs target_correlation in (0, 1)"
                )
        elif self.mode == "fixed_ks":
            if self.target_ks is None or not (0.0 < self.target_ks < 1.0):
                raise ValueError("fixed_ks needs target_ks in (0, 1)")
        if self.mode != "raw" and not any(
            c for c in cods if c != "raw" and not _codecs.get(c).lossless
        ):
            raise ValueError(
                f"mode {self.mode!r} needs at least one lossy codec in the "
                f"allowlist (got {cods}); use Policy.raw() for verbatim storage"
            )

    # -- constructors -------------------------------------------------------

    @classmethod
    def fixed_accuracy(
        cls,
        eb_rel: float | None = None,
        eb_abs: float | None = None,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """The paper's bound-centric contract (Algorithm 1 at this bound).
        `eb_abs` wins when both bounds are given; with neither, defaults
        to `eb_rel=1e-4`."""
        if eb_abs is not None:
            eb_rel = None
        elif eb_rel is None:
            eb_rel = DEFAULT_EB_REL
        return cls("fixed_accuracy", eb_abs=eb_abs, eb_rel=eb_rel,
                   r_sp=r_sp, codecs=tuple(codecs))

    @classmethod
    def fixed_psnr(
        cls,
        db: float,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """Land on `db` dB (value-range PSNR); §7 controller solves the bound."""
        return cls("fixed_psnr", target_psnr=float(db), r_sp=r_sp,
                   codecs=tuple(codecs))

    @classmethod
    def fixed_ratio(
        cls,
        x: float,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """Meet a byte budget: ratio `x` vs 32-bit raw (§7 iso-rate dual)."""
        return cls("fixed_ratio", target_ratio=float(x), r_sp=r_sp,
                   codecs=tuple(codecs))

    @classmethod
    def fixed_ssim(
        cls,
        target: float,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """Land on a structural-similarity floor in (0, 1); the §7.4 metric
        inversion converts it to a per-field PSNR target and the §7
        controller solves the bound (achieved within ±0.02)."""
        return cls("fixed_ssim", target_ssim=float(target), r_sp=r_sp,
                   codecs=tuple(codecs))

    @classmethod
    def fixed_correlation(
        cls,
        target: float,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """Land on a Pearson-correlation floor in (0, 1) between original and
        reconstruction (§7.4 metric inversion; achieved within ±0.005)."""
        return cls("fixed_correlation", target_correlation=float(target),
                   r_sp=r_sp, codecs=tuple(codecs))

    @classmethod
    def fixed_ks(
        cls,
        max_stat: float,
        *,
        r_sp: float = DEFAULT_R_SP,
        codecs: Iterable[str] = _codecs.DEFAULT_CODECS,
    ) -> "Policy":
        """Cap the Kolmogorov-Smirnov distance between the original and
        reconstructed value distributions at `max_stat` in (0, 1) (§7.4
        sample-measured inversion; achieved within ±0.02)."""
        return cls("fixed_ks", target_ks=float(max_stat), r_sp=r_sp,
                   codecs=tuple(codecs))

    @classmethod
    def raw(cls) -> "Policy":
        """Store verbatim — exact bytes, original dtype."""
        return cls("raw", codecs=("raw",))

    # -- serialization --------------------------------------------------------

    def spec(self) -> dict:
        """Compact JSON-safe form, as the reference records it per field."""
        out: dict = {"mode": self.mode}
        for k in ("eb_abs", "eb_rel", "target_psnr", "target_ratio",
                  "target_ssim", "target_correlation", "target_ks"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        if self.mode != "raw":
            out["r_sp"] = self.r_sp
            if self.codecs != _codecs.DEFAULT_CODECS:
                out["codecs"] = list(self.codecs)
        return out

    @classmethod
    def from_spec(cls, spec: dict) -> "Policy":
        kw = dict(spec)
        mode = kw.pop("mode", None)
        if mode not in MODES:
            raise ValueError(
                f"unknown quality mode {mode!r} in policy spec; supported "
                f"modes: {', '.join(MODES)}"
            )
        if "codecs" in kw:
            kw["codecs"] = tuple(kw["codecs"])
        if mode == "raw":
            return cls.raw()
        return cls(mode, **kw)


def _rule_matches(pattern, name: str) -> bool:
    if isinstance(pattern, re.Pattern):
        return pattern.search(name) is not None
    if pattern.startswith("re:"):
        return re.search(pattern[3:], name) is not None
    return fnmatchcase(name, pattern)


@dataclass(frozen=True)
class PolicySet:
    """Per-field policy resolution: ordered rules, first match wins, else
    `default`. Patterns are globs over the full leaf name ("opt/*",
    "*/kv/*"), ``re:``-prefixed regexes, or pre-compiled `re.Pattern`s."""

    default: Policy
    rules: tuple = field(default_factory=tuple)

    def __post_init__(self):
        if not isinstance(self.default, Policy):
            raise TypeError(f"default must be a Policy, got {type(self.default)}")
        rules = tuple(tuple(r) for r in self.rules)
        for pat, pol in rules:
            if not isinstance(pol, Policy):
                raise TypeError(f"rule {pat!r}: expected a Policy, got {type(pol)}")
            if isinstance(pat, str) and pat.startswith("re:"):
                re.compile(pat[3:])  # fail loudly at construction
            elif not isinstance(pat, (str, re.Pattern)):
                raise TypeError(f"rule pattern must be str or re.Pattern, got {pat!r}")
        object.__setattr__(self, "rules", rules)

    def resolve(self, name: str) -> Policy:
        for pat, pol in self.rules:
            if _rule_matches(pat, name):
                return pol
        return self.default


def group_by_policy(pol_of: dict[int, Policy]) -> dict[Policy, list[int]]:
    """Leaf indices grouped by resolved policy: groups in first-appearance
    order, members in index order. A single-policy tree is one group with
    every index in order, so its packed decision batches, and therefore its
    decisions, equal a direct `select_many` over the same fields."""
    groups: dict[Policy, list[int]] = {}
    for i in sorted(pol_of):
        groups.setdefault(pol_of[i], []).append(i)
    return groups


def policy_set_spec(pset: PolicySet) -> dict:
    """JSON-safe form of a PolicySet (a checkpoint manifest's top-level
    ``policy`` record): the default's spec, and the rules as [pattern, spec]
    pairs (a compiled pattern as ``re:<pattern>``)."""

    def pat_str(pat) -> str:
        return f"re:{pat.pattern}" if isinstance(pat, re.Pattern) else pat

    out: dict = {"default": pset.default.spec()}
    if pset.rules:
        out["rules"] = [[pat_str(p), pol.spec()] for p, pol in pset.rules]
    return out


# ---------------------------------------------------------------------------
# Serving-tier policies and request resolution (DESIGN.md §9)
# ---------------------------------------------------------------------------


def request_kv_name(rid: int, context_len: int, long_threshold: int) -> str:
    """Canonical per-request KV-policy leaf name for the serving tier:
    ``kv/long/<rid>`` when the request's total context (prompt + budgeted
    new tokens) reaches `long_threshold`, else ``kv/short/<rid>``. The
    batcher resolves this name against its `PolicySet` once at admission,
    so the page policy holds for the request's whole lifetime."""
    kind = "long" if context_len >= long_threshold else "short"
    return f"kv/{kind}/{rid}"


def serving_policies(
    target_ratio: float = 8.0, *, r_sp: float = DEFAULT_R_SP
) -> PolicySet:
    """The serving tier's stock PolicySet: long-context requests
    (``kv/long/*``) trade KV page fidelity for a `fixed_ratio` byte budget
    on evicted pages; short requests stay `raw` (evict/restore is
    bit-identical)."""
    return PolicySet(
        default=Policy.raw(),
        rules=(("kv/long/*", Policy.fixed_ratio(target_ratio, r_sp=r_sp)),),
    )


def as_policy_set(policy) -> PolicySet:
    """Coerce a Policy | PolicySet into a PolicySet."""
    if isinstance(policy, PolicySet):
        return policy
    if isinstance(policy, Policy):
        return PolicySet(default=policy)
    raise TypeError(
        f"expected Policy or PolicySet, got {type(policy).__name__}: {policy!r}"
    )


# ---------------------------------------------------------------------------
# Legacy-kwarg shim
# ---------------------------------------------------------------------------


def policy_from_kwargs(
    where: str,
    *,
    mode: str | None = None,
    eb_abs: float | None = None,
    eb_rel: float | None = None,
    target_psnr: float | None = None,
    target_ratio: float | None = None,
    r_sp: float | None = None,
    default_eb_rel: float | None = None,
    stacklevel: int = 3,
) -> Policy:
    """Map the deprecated keyword spelling onto a `Policy`, with a
    `DeprecationWarning`. The mapping keeps each call site's old defaults
    (eb_abs wins over eb_rel; `default_eb_rel` is the bound the old
    signature defaulted to, None where it raised), so shimmed calls decide
    and encode as the `Policy` spelling does."""
    mode = mode or "fixed_accuracy"
    r_sp = DEFAULT_R_SP if r_sp is None else r_sp
    if mode == "fixed_accuracy":
        if eb_abs is None and eb_rel is None:
            if default_eb_rel is None:
                raise ValueError("fixed_accuracy needs eb_abs or eb_rel")
            eb_rel = default_eb_rel
        pol = Policy.fixed_accuracy(eb_rel=eb_rel, eb_abs=eb_abs, r_sp=r_sp)
    elif mode == "fixed_psnr":
        if target_psnr is None:
            raise ValueError("fixed_psnr needs target_psnr")
        pol = Policy.fixed_psnr(target_psnr, r_sp=r_sp)
    elif mode == "fixed_ratio":
        if target_ratio is None:
            raise ValueError("fixed_ratio needs target_ratio")
        pol = Policy.fixed_ratio(target_ratio, r_sp=r_sp)
    elif mode in METRIC_MODES:
        raise ValueError(
            f"mode {mode!r} has no legacy-kwarg spelling; pass "
            f"policy=Policy.{mode}(target) instead (repro_torch.core.policy)"
        )
    else:
        raise ValueError(
            f"unknown quality mode {mode!r}; supported modes: {', '.join(MODES)}"
        )
    warnings.warn(
        f"{where}: mode/eb/target keyword arguments are deprecated; pass "
        f"policy={_policy_repr(pol)} instead (repro_torch.core.policy)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )
    return pol


def _policy_repr(p: Policy) -> str:
    if p.mode == "fixed_accuracy":
        arg = f"eb_abs={p.eb_abs!r}" if p.eb_abs is not None else f"eb_rel={p.eb_rel!r}"
        return f"Policy.fixed_accuracy({arg})"
    attr = TARGET_FIELD.get(p.mode)
    if attr is not None:
        return f"Policy.{p.mode}({getattr(p, attr)!r})"
    return "Policy.raw()"
