"""repro_torch.core — Algorithm 1 for one field, the SZ and ZFP byte
codecs, and the device-resident encode, in PyTorch."""

from . import codecs
from .api import compress
from .policy import Policy, PolicySet
from .selector import (
    CompressedField,
    Selection,
    compression_ratio,
    decompress,
    encode_with_selection,
    select,
)
from .sz import sz_compress, sz_decompress
from .zfp import zfp_compress, zfp_decompress

__all__ = [
    "CompressedField",
    "Policy",
    "PolicySet",
    "Selection",
    "codecs",
    "compress",
    "compression_ratio",
    "decompress",
    "encode_with_selection",
    "select",
    "sz_compress",
    "sz_decompress",
    "zfp_compress",
    "zfp_decompress",
]
