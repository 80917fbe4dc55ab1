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


def dtype_name(x) -> str:
    """The numpy-style dtype name of an array or tensor ("float32", ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)
