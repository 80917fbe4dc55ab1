"""Quality-target controller (port of `repro.core.controller`), partly.

Only `TargetSolution` is here: the record a solved quality target leaves
behind, which `DecisionCache` entries carry and `CacheEntry.to_solution`
rebuilds. The solver itself — `solve`, `solve_many`, `estimate_curves` and
the secant refinement of the fixed_psnr / fixed_ratio / metric modes — is
not ported yet (ROADMAP queue A item 7).
"""

from __future__ import annotations

from dataclasses import dataclass

from .selector import Selection

#: the codecs' working dtype is float32, so ratio targets are defined
#: against 32 bits/value (matching `compression_ratio`)
RAW_BITS = 32.0


@dataclass
class TargetSolution:
    """One field's solved target: the `Selection` to encode with, plus the
    estimates the solve ended on (what the controller believes it hit)."""

    selection: Selection
    mode: str
    target: float        # dB (fixed_psnr), ratio (fixed_ratio), eb (fixed_accuracy),
                         # metric value (fixed_ssim / fixed_correlation / fixed_ks)
    est_psnr: float      # estimated/measured PSNR of the chosen codec
    est_bitrate: float   # estimated bits/value of the chosen codec
    on_target: bool      # False when the solve could only get best-effort close
    #: predicted metric value of the chosen codec (metric modes only; None
    #: elsewhere, so entries without it deserialize unchanged)
    est_metric: float | None = None

    @property
    def est_ratio(self) -> float:
        return RAW_BITS / max(self.est_bitrate, 1e-6)
