"""repro_torch.core — Algorithm 1 for one field and batched over many, the
quality-target controller, the warm path (the decision cache and the
statistical predictor), the SZ and ZFP byte codecs, the device-resident
encode, and pytrees, in PyTorch."""

from . import codecs, quality
from .api import CompressedTree, compress, compress_pytree, decompress_pytree
from .controller import TargetSolution, estimate_curves, solve, solve_many
from .decision_cache import CacheEntry, DecisionCache
from .policy import Policy, PolicySet
from .predictor import (
    FieldStats,
    confidence,
    fingerprint_of,
    predict_curves,
    predict_selection,
    select_many_predicted,
)
from .selector import (
    CompressedField,
    Selection,
    compression_ratio,
    decompress,
    encode_with_selection,
    select,
    select_and_compress,
    select_many,
)
from .sz import SZStats, sz_compress, sz_decompress, sz_stats
from .zfp import zfp_compress, zfp_decompress

__all__ = [
    "SZStats",
    "CacheEntry",
    "CompressedField",
    "CompressedTree",
    "DecisionCache",
    "FieldStats",
    "Policy",
    "PolicySet",
    "Selection",
    "TargetSolution",
    "codecs",
    "compress",
    "compress_pytree",
    "compression_ratio",
    "confidence",
    "decompress",
    "decompress_pytree",
    "encode_with_selection",
    "estimate_curves",
    "fingerprint_of",
    "predict_curves",
    "predict_selection",
    "quality",
    "select",
    "select_and_compress",
    "select_many",
    "select_many_predicted",
    "solve",
    "solve_many",
    "sz_compress",
    "sz_decompress",
    "sz_stats",
    "zfp_compress",
    "zfp_decompress",
]
