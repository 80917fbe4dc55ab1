"""repro_torch — the PyTorch/CUDA port of `repro`: online rate-distortion
selection between SZ- and ZFP-style error-bounded lossy compression, run
on an NVIDIA H100.

The package mirrors `repro`'s layout (`core/`, `kernels/`, `runtime/`,
`checkpoint/`, `models/`, `configs/`, `launch/`; so far the dense decoder
models and the serving tier, not training) and imports neither JAX nor
`repro`. Entry points run on the GPU unless the caller
passes ``device="cpu"`` (see `repro_torch.device`).
"""

from . import device  # noqa: F401
