"""Fused prequantize + 2-D/3-D integer-Lorenzo encode, and the decode
side's dequantize: CUDA kernels for Hopper and their wrappers (K1-K4 of
the port).

The kernels (``csrc/lorenzo.cu``) replace the Pallas TPU kernels of
`repro.kernels.lorenzo`:

* K1 `lorenzo2d_encode` / K2 `lorenzo3d_encode`: one pass over device
  memory computing ``round(x / 2eb)`` and the n-D Lorenzo difference of the
  integer codes, exact in int32;
* K3 `dequantize2d` / K4 `dequantize3d`: ``float32(k) * 2eb``, elementwise.

Each wrapper takes a contiguous tensor of its rank (float32 for the
encode, int32 for the dequantize). A CUDA tensor launches the kernel on
the current stream, or raises; a CPU tensor — the caller asked for the
CPU — runs the plain torch version in `ref.py`.
`LAUNCHES` counts kernel launches per kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from .ref import dequantize_ref, lorenzo_encode_ref

#: kernel launches per kernel since the last reset (CPU calls do not count)
LAUNCHES = {
    "lorenzo2d_encode": 0,
    "lorenzo3d_encode": 0,
    "dequantize2d": 0,
    "dequantize3d": 0,
}


#: the counts are exact under the threads of `compress_pytree`'s encoders
_COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    with _COUNT_LOCK:
        counts[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(x: torch.Tensor, ndim: int, name: str, dtype=torch.float32) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D tensor, got shape {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(name: str, x: torch.Tensor, eb: float, out_dtype=torch.int32) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    fn = getattr(_build.load("lorenzo"), name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), *x.shape, ctypes.c_float(eb), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    count_launch(LAUNCHES, name)
    return out


def lorenzo2d_encode(x: torch.Tensor, eb: float) -> torch.Tensor:
    """K1: fused quantize + 2-D Lorenzo, f32 (m, n) -> int32 (m, n)."""
    _check(x, 2, "lorenzo2d_encode")
    if x.device.type == "cpu":
        return lorenzo_encode_ref(x, eb)
    return _launch("lorenzo2d_encode", x, float(eb))


def lorenzo3d_encode(x: torch.Tensor, eb: float) -> torch.Tensor:
    """K2: fused quantize + 3-D Lorenzo, f32 (z, m, n) -> int32 (z, m, n)."""
    _check(x, 3, "lorenzo3d_encode")
    if x.device.type == "cpu":
        return lorenzo_encode_ref(x, eb)
    return _launch("lorenzo3d_encode", x, float(eb))


def dequantize2d(k: torch.Tensor, eb: float) -> torch.Tensor:
    """K3: elementwise dequantize, int32 (m, n) -> float32 (m, n)."""
    _check(k, 2, "dequantize2d", torch.int32)
    if k.device.type == "cpu":
        return dequantize_ref(k, eb)
    return _launch("dequantize2d", k, float(eb), torch.float32)


def dequantize3d(k: torch.Tensor, eb: float) -> torch.Tensor:
    """K4: elementwise dequantize, int32 (z, m, n) -> float32 (z, m, n)."""
    _check(k, 3, "dequantize3d", torch.int32)
    if k.device.type == "cpu":
        return dequantize_ref(k, eb)
    return _launch("dequantize3d", k, float(eb), torch.float32)
