"""Error-feedback gradient compression — the paper's Stage I/II applied to
distributed-training traffic (DESIGN.md §2, §6), in torch.

Port of `repro.optim.compress`. Each step, per gradient tensor:
  g' = g + residual                      (error feedback)
  k  = round(g' / (2*eb))                (prequantization — SZ Stage II)
  residual' = g' - 2*eb*k                (carried quantization error)
and the optimizer consumes the dequantized g~ = 2*eb*k. The integer codes
are what would cross the wire; `wire_bits_per_value` reports their
entropy-coded size (Eq. (5)-style) without leaving the device. eb is
value-range-relative per tensor, so the scheme is the paper's
error-bounded quantization with Theorem-1 semantics (pointwise error
<= eb, zero drift thanks to error feedback).

Two choices decide agreement with the reference bit for bit:

* The residual is taken with one rounding, ``g' - k*delta`` as a fused
  multiply-add, because the reference's compiled program contracts it into
  an FMA. The product of two float32 values is exact in float64, and so is
  the difference of the two close values, so the float64 form rounded
  once to float32 is the FMA's result on any device.
* The histogram counts are exact integers (`torch.bincount`). The
  reference accumulates them in float32, which stops counting at 2^24 in
  a bin (a fault of the reference, ROADMAP.md §C): at the sizes where
  both are exact the wire bits agree.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import device as _device
from ..core import pytree
from ..core.policy import Policy
from ..core.xla_f32 import _xla_log2
from ..runtime import dist, sharding


@dataclasses.dataclass(frozen=True)
class GradCompressConfig:
    eb_rel: float = 1e-3   # of each tensor's grad value range
    hist_bits: int = 8     # entropy estimated over 2^hist_bits clipped codes
    # optional Policy spelling of the bound (DESIGN.md §2): a fixed_accuracy
    # policy whose eb_rel overrides the field above — gradient traffic is
    # in-graph prequantization, so only the bound-centric contract applies
    policy: Policy | None = None

    def __post_init__(self):
        if self.policy is not None:
            if self.policy.mode != "fixed_accuracy" or self.policy.eb_rel is None:
                raise ValueError(
                    "gradient compression carries a value-range-relative "
                    "bound: pass Policy.fixed_accuracy(eb_rel=...)"
                )
            object.__setattr__(self, "eb_rel", self.policy.eb_rel)

    @classmethod
    def from_policy(cls, policy: Policy, hist_bits: int = 8) -> "GradCompressConfig":
        return cls(hist_bits=hist_bits, policy=policy)


def init(params: Any) -> dict:
    """Zero residuals shaped like `params`, float32, on each leaf's device
    (laid out like a DTensor leaf)."""
    return {"residual": pytree.tree_map(lambda p: sharding.zeros_like(p, torch.float32), params)}


#: values a float64 slice of the residual's multiply-add holds at once
_FMA_CHUNK = 1 << 24


def _fma_residual(g: torch.Tensor, k: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """g - k * delta in float64 rounded once to float32 (the reference's
    fused multiply-add), a slice at a time: whole, the float64 temporaries
    would take 24 bytes a value of a leaf at once."""
    out = torch.empty_like(g)
    d = delta.double()
    for o, gs, ks in zip(out.view(-1).split(_FMA_CHUNK), g.view(-1).split(_FMA_CHUNK),
                         k.view(-1).split(_FMA_CHUNK)):
        o.copy_(gs.double() - ks.double() * d)
    return out


def _leaf(g: torch.Tensor, r: torch.Tensor, eb_rel: float, half: int):
    """(dequantized, residual, code entropy in bits) of one leaf.

    A DTensor leaf (its residual laid out alike) is taken on each rank's
    shard with the leaf's statistics: its max and min over every rank (an
    all-reduce, exact in any order), and the histogram summed, exact in
    int64, over the ranks that own a unique shard (a replica counts
    once). The dequantized gradient and the residual keep its layout."""
    layout = sharding.layout_of(g)
    sharded = layout is not None
    if sharded:
        shape, owner = g.shape, sharding.owns_shard(g)
        g, r = g.to_local(), r.to_local()
    g = g.to(torch.float32) + r
    hi_lo = torch.stack([torch.max(g), -torch.min(g)])
    if sharded:
        hi_lo = dist.pmax(hi_lo)
    vr = torch.clamp(hi_lo[0] + hi_lo[1], min=1e-12)  # max + (-min) is max - min, bit for bit
    delta = 2.0 * (vr * eb_rel)
    k = torch.round(g / delta)  # a true division; round half to even
    gq = k * delta
    resid = _fma_residual(g, k, delta)  # the FMA
    kc = torch.clamp(k, -half, half) + half
    codes = _device.to_int_saturating(kc).reshape(-1)
    counts = torch.bincount(codes, minlength=2 * half + 1)
    if sharded:
        counts = dist.psum(counts if owner else torch.zeros_like(counts))
        gq = sharding.from_local(gq, layout, shape)
        resid = sharding.from_local(resid, layout, shape)
    p = counts.to(torch.float32) / torch.clamp(counts.sum(), min=1).to(torch.float32)
    plogp = p * _xla_log2(torch.clamp(p, min=1e-30))
    ent = -torch.sum(torch.where(p > 0, plogp, 0.0))
    return gq, resid, ent


def compress(cfg: GradCompressConfig, grads: Any, state: dict) -> tuple[Any, dict, dict]:
    """Returns (dequantized grads, new state, metrics incl. wire bits/value).

    Leaves are taken in the reference's order (`core/pytree.py`); the new
    residuals are fresh tensors (the caller may copy them into the old
    ones). On one process, nothing here waits for the device but
    `torch.bincount`, which reads its input's maximum on the host. A
    DTensor leaf also waits for its two collectives (`_leaf`: the range
    and the histogram cross the ranks through the host under gloo)."""
    half = 2 ** (cfg.hist_bits - 1) - 1
    flat, treedef = pytree.flatten_with_path(grads)
    rflat, rdef = pytree.flatten_with_path(state["residual"])
    if rdef != treedef:
        raise ValueError("compress: the residual tree differs from the gradient tree")
    outs = [_leaf(g, r, cfg.eb_rel, half) for (_, g), (_, r) in zip(flat, rflat)]
    gq = pytree.unflatten(treedef, [o[0] for o in outs])
    resid = pytree.unflatten(treedef, [o[1] for o in outs])
    ents = torch.stack([o[2] for o in outs])
    sizes = torch.tensor([float(g.numel()) for _, g in flat], dtype=torch.float32,
                         device=ents.device)
    wire_bits = torch.sum(ents * sizes) / torch.sum(sizes) + 0.5  # + Huffman offset
    return gq, {"residual": resid}, {"wire_bits_per_value": wire_bits}
