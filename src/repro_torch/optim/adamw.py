"""AdamW with global-norm clipping and warmup+cosine schedule, in torch.

Port of `repro.optim.adamw`. Everything stays on the device in float32:
the step count is a 0-d int32 tensor, and the clip scale, the learning
rate and the bias corrections are 0-d tensors, so an update never waits
for the device. `update` writes the new params, m and v into the tensors
it was given (the reference's jitted step donates them) and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a float32 tensor): linear warmup, then a
    cosine decay to `min_lr_frac` of `lr`. Evaluated as the reference's
    compiled program does: the divisions by constants are multiplications
    by their float32 reciprocals, and ``min_lr_frac + c * (1 + cos)`` is
    one fused multiply-add."""
    warm = torch.clamp(step * (1.0 / max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) * (1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0
    )
    half_cos = _f32((1 - cfg.min_lr_frac) * 0.5)
    cos = ((1 + torch.cos(math.pi * t)).double() * half_cos + _f32(cfg.min_lr_frac)).float()
    return cfg.lr * warm * cos


def _f32(x: float) -> float:
    """`x` rounded to float32 (held in a Python float)."""
    return float(np.float32(x))


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: Any) -> dict:
    """Zero moments shaped like `params` (float32) and step 0, on the
    params' device."""
    leaves = pytree.leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": pytree.tree_map(_zeros, params), "v": pytree.tree_map(_zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in pytree.leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: dict, params: Any) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics). The new params, m and v
    are the given tensors, updated in place; the step is a new tensor."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(torch.full_like(gn, cfg.clip_norm) / torch.clamp(gn, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    lr = schedule(cfg, stepf)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(pytree.leaves(params), pytree.leaves(grads),
                          pytree.leaves(state["m"]), pytree.leaves(state["v"])):
        # torch.add(a, b, alpha=c) is one fused multiply-add, b * c + a, as
        # the reference's compiled program contracts these lines
        g = g.to(torch.float32) * scale
        torch.add(g * (1 - b1), m, alpha=b1, out=m)
        torch.add(torch.square(g) * (1 - b2), v, alpha=b2, out=v)
        mu = m / (bc1 * (torch.sqrt(v / bc2) + cfg.eps))  # = mh / (sqrt(vh) + eps)
        delta = torch.add(mu, p.to(torch.float32), alpha=cfg.weight_decay)
        # the reference fuses this line too; here lr * delta rounds first,
        # which moves a parameter by an ulp at most (lr * delta << p)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gn, "lr": lr}
