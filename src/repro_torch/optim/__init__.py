"""repro_torch.optim — AdamW and error-feedback gradient compression, in
PyTorch (port of `repro.optim`)."""

from . import adamw, compress
from .adamw import AdamWConfig
from .compress import GradCompressConfig
