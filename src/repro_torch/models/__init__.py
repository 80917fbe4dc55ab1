"""Model zoo, in torch: declarative param trees + plain-torch apply
functions (port of `repro.models`: the decoder-only families (dense,
MoE, MLA), xLSTM, the Zamba2-style hybrid and the encoder-decoder)."""

from .config import ModelConfig, reduced_for_smoke
from .model import build_model

__all__ = ["ModelConfig", "build_model", "reduced_for_smoke"]
