"""Model zoo, in torch: declarative param trees + plain-torch apply
functions (port of `repro.models`; the decoder-only families so far:
dense, MoE and MLA)."""

from .config import ModelConfig, reduced_for_smoke
from .model import build_model

__all__ = ["ModelConfig", "build_model", "reduced_for_smoke"]
