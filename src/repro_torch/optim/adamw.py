"""AdamW with global-norm clipping and warmup+cosine schedule, in torch.

Port of `repro.optim.adamw`. Everything stays on the device in float32:
the step count is a 0-d int32 tensor, and the clip scale, the learning
rate and the bias corrections are 0-d tensors, so an update never waits
for the device. `update` writes the new params, m and v into the tensors
it was given (the reference's jitted step donates them) and returns them.
DTensor leaves (a train step under a mesh) are updated shard by shard;
the global norm crosses the ranks (`global_norm`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core import pytree
from ..runtime import dist, sharding


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


def init(params: Any) -> dict:
    """Zero moments shaped like `params` (float32; a DTensor leaf's laid out
    like it) and step 0, on the params' device."""
    leaves = pytree.leaves(params)
    dev = None
    if leaves:
        dev = (sharding.mesh_device(leaves[0].device_mesh) if dist.is_dtensor(leaves[0])
               else leaves[0].device)
    return {"m": pytree.tree_map(lambda p: sharding.zeros_like(p, torch.float32), params),
            "v": pytree.tree_map(lambda p: sharding.zeros_like(p, torch.float32), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, the leaves added in tree
    order. Over DTensor leaves, each rank sums the squares of the unique
    shards it owns (and rank 0 those of any plain leaf), and one
    collective adds the ranks' sums in rank order (`dist.psum`): the same
    bits on every rank."""
    leaves = pytree.leaves(tree)
    sharded = any(dist.is_dtensor(g) for g in leaves)

    def mine(g) -> torch.Tensor:
        own = not sharded or dist.process_index() == 0
        if dist.is_dtensor(g):
            own, g = sharding.owns_shard(g), g.to_local()
        s = torch.sum(torch.square(g.to(torch.float32)))
        return s if own else torch.zeros_like(s)

    per_leaf = torch.stack([mine(g) for g in leaves])
    if sharded:
        per_leaf = dist.psum(per_leaf)
    return torch.sqrt(sum(per_leaf.unbind()))


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
        # elementwise: a DTensor leaf is updated on each rank's shard
        p, g, m, v = (dist.local(t) for t in (p, g, m, v))
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
