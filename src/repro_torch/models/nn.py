"""Minimal declarative NN substrate: parameter descriptors and layers, in
torch.

Port of `repro.models.nn`. Parameters are declared as nested dicts of `P`
descriptors (shape, logical axes, init); `init_tree` draws them from an
explicit `torch.Generator` on an explicit device, and
`params_from_reference` carries a tree of the reference's weights (or its
optimizer state) across as numpy arrays, so both packages can compute with
the same weights.
The layers are plain functions on tensors.

Numerics follow the reference: activations in the compute dtype of `x`
(bfloat16 by default), every weight cast to it at each call (`dense`),
and float32 for the norm statistics, the RoPE angles, the attention
logits and softmax. Attention is the reference's plain form (an einsum,
the -1e30 mask, softmax in float32), not a fused library kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter descriptor: shape, logical axes (len == ndim), init."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"P: shape {self.shape} and axes {self.axes} differ in rank")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a cache tensor (the reference's ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def is_desc(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` applied to every leaf of a tree of nested dicts, keys in sorted
    order (the reference's `jax.tree_util` order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _fan_in(shape: tuple[int, ...]) -> int:
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def init_param(p: P, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """One parameter: zeros, ones, or normal draws from `generator` times
    the descriptor's scale (0.02 for embeddings, else 1/sqrt(fan_in)).
    The draws are torch's, not `jax.random`'s."""
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=device)
    scale = p.scale
    if scale is None:
        scale = 0.02 if p.init == "embed" else 1.0 / math.sqrt(max(_fan_in(p.shape), 1))
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(p.dtype)


def init_tree(tree: Any, generator: torch.Generator, *, device=None) -> Any:
    """Materialize a descriptor tree into parameters on `device` (default
    the GPU), drawn from `generator`, which must live on that device."""
    dev = _device.resolve(device)
    return tree_map(lambda p: init_param(p, generator, dev), tree)


def abstract_tree(tree: Any) -> Any:
    """Shapes and dtypes with no storage (meta tensors): the layout rules'
    `abstract` argument and dry runs."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), tree)


def axes_tree(tree: Any) -> Any:
    """The logical-axis tree matching the params (for the layout rules of
    `runtime/sharding.py`)."""
    return tree_map(lambda p: p.axes, tree)


def _reference_leaf(a, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bfloat16
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def params_from_reference(tree: Any, *, device=None) -> Any:
    """The reference's parameter tree, or its optimizer state (``{"adam":
    {"m", "v", "step"}, "gc": {"residual"}}``), as nested dicts of numpy
    arrays (``jax.tree_util.tree_map(np.asarray, tree)``), as tensors on
    `device` (default the GPU): the same keys, shapes and dtypes (Adam's
    step a 0-d int32 tensor)."""
    dev = _device.resolve(device)
    return tree_map(lambda a: _reference_leaf(a, dev), tree)


def stack_layers(descs: list[Any]) -> Any:
    """Stack homogeneous per-layer descriptor trees along a leading 'layers'
    axis (the reference's scan-over-layers layout)."""
    n = len(descs)
    return tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale, p.dtype), descs[0]
    )


def unstack(tree: Any, n: int) -> list[Any]:
    """The `n` layers of a tree stacked on a leading axis, as views
    (`torch.unbind`, whose backward stacks the layers' gradients in one
    copy where indexing would add a full-size gradient per layer)."""
    leaves = tree_map(lambda a: torch.unbind(a, 0), tree)
    return [tree_map(lambda t: t[i], leaves) for i in range(n)]


def layer(tree: Any, i: int) -> Any:
    """Layer `i` of a tree stacked on a leading axis (views, no copy)."""
    return tree_map(lambda a: a[i], tree)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Activation sharding constraint to logical axes: a no-op (compute
    under a mesh is ROADMAP queue A item 14b)."""
    return x


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in the compute dtype of x (the
    weight is cast at every call, as in the reference)."""
    return torch.matmul(x, w.to(x.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: (B, L, H, Dh) with even Dh; positions: (B, L)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, L, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: query-chunk size for the memory-bounded attention path
ATTN_Q_CHUNK = 1024


def _is_vector(v) -> bool:
    return isinstance(v, torch.Tensor) and v.ndim > 0


def _attn_direct(qr, k, v, causal, q_offset, window, kv_len, dh):
    b, lq = qr.shape[:2]
    lk = k.shape[1]
    dev = qr.device
    logits = torch.einsum("blhrd,bmhd->bhrlm", qr, k).to(torch.float32)
    logits = logits / math.sqrt(dh)
    if _is_vector(q_offset) or _is_vector(kv_len):
        # per-slot clocks (paged serving, DESIGN.md §9): q_offset / kv_len
        # are (B,) vectors, so the mask gains a batch axis
        qpos = torch.arange(lq, device=dev)[None, :, None] + torch.reshape(
            torch.as_tensor(q_offset, device=dev), (-1, 1, 1))
        kpos = torch.arange(lk, device=dev)[None, None, :]
        mask = torch.ones((1, lq, lk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        if kv_len is not None:
            mask = mask & (kpos < torch.reshape(torch.as_tensor(kv_len, device=dev), (-1, 1, 1)))
        logits = torch.where(mask[:, None, None], logits, -1e30)
    else:
        qpos = torch.arange(lq, device=dev)[:, None] + q_offset
        kpos = torch.arange(lk, device=dev)[None, :]
        mask = torch.ones((lq, lk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        if kv_len is not None:
            mask = mask & (kpos < kv_len)
        logits = torch.where(mask[None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(qr.dtype)
    return torch.einsum("bhrlm,bmhd->blhrd", w, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,
    window: int | None = None,
    kv_len: torch.Tensor | int | None = None,
    q_chunk: int | None = None,
) -> torch.Tensor:
    """GQA attention. q: (B, Lq, Hq, Dh); k/v: (B, Lk, Hkv, Dh|Dv).

    `q_offset`: absolute position of q[0] (decode). `window`: sliding-window
    size. `kv_len`: valid KV prefix length (decode with preallocated cache).
    `q_offset` and `kv_len` may also be per-slot (B,) vectors, the paged
    serving tier's per-slot clocks (DESIGN.md §9), which batches the mask.

    Queries longer than `q_chunk` (default `ATTN_Q_CHUNK`) run in chunks.
    With a static (int) q_offset the causal structure also truncates each
    chunk's KV prefix (the flash-attention triangle saving).
    """
    b, lq, hq, dh = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qr = q.reshape(b, lq, hkv, rep, dh)
    qc = q_chunk or ATTN_Q_CHUNK
    if lq <= qc:
        out = _attn_direct(qr, k, v, causal, q_offset, window, kv_len, dh)
        return out.reshape(b, lq, hq, v.shape[-1])
    static_off = isinstance(q_offset, int)
    outs = []
    for s in range(0, lq, qc):
        e = min(lq, s + qc)
        qs = qr[:, s:e]
        if static_off and causal and kv_len is None:
            # static causal truncation of the KV prefix (triangle saving)
            hi = min(k.shape[1], q_offset + e)
            lo = max(0, q_offset + s - window + 1) if window is not None else 0
            lo = (lo // 128) * 128  # the reference's lane-aligned slices
            out = _attn_direct(
                qs, k[:, lo:hi], v[:, lo:hi], causal, q_offset + s - lo, window, None, dh
            )
        else:
            out = _attn_direct(qs, k, v, causal, q_offset + s, window, kv_len, dh)
        outs.append(out)
    return torch.cat(outs, dim=1).reshape(b, lq, hq, v.shape[-1])


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                prev: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of x (B, L, C) with kernel w (K, C) and bias
    b (C,), in the dtype of x, then silu in float32 (the Mamba2 and mLSTM
    input convs). The K-1 steps before x are `prev` (B, K-1, C), a decode
    cache, or zeros. Returns (out, the last K-1 input steps: the next
    call's `prev`)."""
    k, l = w.shape[0], x.shape[1]
    if prev is not None:
        ext = torch.cat([prev.to(x.dtype), x], dim=1)
    else:
        ext = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    wins = torch.stack([ext[:, i:i + l, :] for i in range(k)], dim=2)  # (B, L, K, C)
    out = torch.einsum("blkc,kc->blc", wins, w.to(x.dtype)) + b.to(x.dtype)
    return torch.nn.functional.silu(out.to(torch.float32)).to(x.dtype), ext[:, -(k - 1):, :]


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    h = shard(h, "batch", None, "mlp")
    return dense(h, w_down)


def gelu_mlp(x, w_up, w_down):
    # jax.nn.gelu defaults to the tanh approximation
    h = torch.nn.functional.gelu(dense(x, w_up).to(torch.float32), approximate="tanh")
    h = shard(h.to(x.dtype), "batch", None, "mlp")
    return dense(h, w_down)


def relu2_mlp(x, w_up, w_down):
    h = torch.square(torch.relu(dense(x, w_up).to(torch.float32))).to(x.dtype)
    h = shard(h, "batch", None, "mlp")
    return dense(h, w_down)
