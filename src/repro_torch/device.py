"""Device resolution for the port's entry points.

Every entry point takes ``device=``. The default is the GPU: with no CUDA
device and no explicit ``device="cpu"`` the call raises, so a run that was
meant for the card never moves to the CPU without the caller asking.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The `torch.device` a call runs on: ``cuda`` unless given, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; repro_torch runs on the GPU by "
                "default — pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """`x` (numpy array or tensor) as a contiguous float32 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        arr = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
        if not arr.flags.writeable:  # torch.from_numpy wants a writeable buffer
            arr = arr.copy()
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=torch.float32).contiguous()


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor or array (copies device tensors)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_int_saturating(v: torch.Tensor, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """float -> signed integer `dtype` as XLA's convert does it (and the
    card's `cvt.rzi.sat`): truncated toward zero, saturated at the type's
    limits (+-inf included), NaN -> 0. A bare `.to(dtype)` is undefined
    out of range and wraps on the x86 host (inf -> INT32_MIN)."""
    info = torch.iinfo(dtype)
    hi, lo = v >= 2.0 ** (info.bits - 1), v < -(2.0 ** (info.bits - 1))
    out = torch.where(hi | lo | v.isnan(), 0.0, v).to(dtype)
    return out.masked_fill_(hi, info.max).masked_fill_(lo, info.min)


#: torch dtypes numpy has no type for, carried as raw integers of their width
_NUMPY_ABSENT = {"bfloat16": (torch.bfloat16, torch.int16, np.int16)}


def raw_bytes(x) -> bytes:
    """The exact bytes of an array or tensor, in C order (a bfloat16 tensor
    as its 16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        spec = _NUMPY_ABSENT.get(dtype_name(t))
        return (t.view(spec[1]) if spec else t).numpy().tobytes()
    return np.asarray(x).tobytes()


def from_raw_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    """Inverse of `raw_bytes`: a writeable CPU tensor of the recorded dtype
    name and shape."""
    spec = _NUMPY_ABSENT.get(dtype)
    arr = np.frombuffer(bytearray(data), dtype=spec[2] if spec else np.dtype(dtype))
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(spec[0]) if spec else t


def itemsize(dtype: str) -> int:
    """Bytes per value of a recorded dtype name, numpy's or torch's."""
    spec = _NUMPY_ABSENT.get(dtype)
    return spec[0].itemsize if spec else np.dtype(dtype).itemsize


def dtype_name(x) -> str:
    """The numpy-style dtype name of an array or tensor ("float32", ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)
