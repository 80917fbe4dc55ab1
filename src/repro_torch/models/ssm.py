"""Mamba2 (SSD — state-space duality) blocks, chunked-parallel form, in
torch.

Port of `repro.models.ssm`. Prefill runs the chunked algorithm (an
intra-chunk attention-like term plus an inter-chunk state recurrence,
here a Python loop over the L/chunk chunks); decode is the O(1) recurrent
update.

State convention per head: h in R^{N x P} (state x head_dim),
  h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t,   y_t = C_t h_t + D x_t
with A < 0 scalar per head, B/C shared across heads per group (G=1 here).

Dtypes follow the reference step by step: the decay weights, the chunk
states and the inter-chunk carry are rounded to the compute dtype of `x`,
and so is the state read from the (float32) cache, at every prefill and
decode step. The cache is written IN PLACE (as `blocks.apply_attn`'s):
the returned cache holds the given tensors with the new state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nn
from .config import ModelConfig, SSMCfg
from .nn import P, TensorSpec, causal_conv, dense, rms_norm, shard


def desc_mamba(cfg: ModelConfig) -> dict:
    s: SSMCfg = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    g = s.n_groups
    conv_dim = d_in + 2 * g * s.state
    return {
        "norm": P((d,), ("norm",), "ones"),
        "in_proj": P((d, 2 * d_in + 2 * g * s.state + nh), ("embed", "mlp")),
        "conv_w": P((s.conv, conv_dim), (None, "mlp")),
        "conv_b": P((conv_dim,), ("mlp",), "zeros"),
        "A_log": P((nh,), (None,), "zeros"),   # A = -exp(A_log) ~ -1
        "D": P((nh,), (None,), "ones"),
        "dt_bias": P((nh,), (None,), "zeros"),
        "out_norm": P((d_in,), ("norm",), "ones"),
        "out_proj": P((d_in, d), ("mlp", "embed")),
    }


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a: (..., Q) -> (..., Q, Q) with [t, s] = sum_{s < r <= t} log_a_r,
    -inf above the diagonal (the 1-SS decay matrix of the SSD paper)."""
    q = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=log_a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,    # (B, L, H, P)
    dt: torch.Tensor,   # (B, L, H) positive
    A: torch.Tensor,    # (H,) negative
    Bm: torch.Tensor,   # (B, L, N)  (G=1, shared across heads)
    Cm: torch.Tensor,   # (B, L, N)
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,L,H,P), h_final (B,H,N,P))."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of chunk {chunk}")
    nc = l // chunk
    dtype = x.dtype
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = Bm.reshape(b, nc, chunk, n)
    Cc = Cm.reshape(b, nc, chunk, n)
    log_a = dtc * A  # (b, nc, q, h), <= 0
    log_a_h = torch.movedim(log_a, -1, 2)  # (b, nc, h, q)
    dt_h = torch.movedim(dtc, -1, 2)  # (b, nc, h, q)
    cum = torch.cumsum(log_a_h, dim=-1)  # (b, nc, h, q)
    # intra-chunk: y[t] = sum_{s<=t} exp(cum_t - cum_s) dt_s (C_t . B_s) x_s
    Lmat = torch.exp(_segsum(log_a_h))  # (b, nc, h, q, q)
    scores = torch.einsum("bctn,bcsn->bcts", Cc, Bc)  # (b, nc, q, q)
    W = scores[:, :, None] * Lmat * dt_h[:, :, :, None, :]
    y_intra = torch.einsum("bchts,bcshp->bcthp", W.to(dtype), xc)
    # chunk states: S_c = sum_s exp(cum_end - cum_s) dt_s B_s (x) x_s
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (b, nc, h, q)
    wS = (decay_to_end * dt_h).to(dtype)  # (b, nc, h, q)
    S = torch.einsum("bchs,bcsn,bcshp->bchnp", wS, Bc, xc)  # (b, nc, h, n, p)
    # inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(cum[..., -1]).to(dtype)  # (b, nc, h)
    hcur = torch.zeros((b, h, n, p), dtype=dtype, device=x.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (b, nc, h, n, p)
    # inter contribution: y[t] += exp(cum_t) C_t . h_prev_chunk
    in_decay = torch.exp(cum)  # (b, nc, h, q)
    y_inter = torch.einsum("bctn,bchnp,bcht->bcthp", Cc, h_prev, in_decay.to(dtype))
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y, hcur


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(1 + e^x) with no threshold (torch's
    `F.softplus` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def apply_mamba(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Mamba2 block. cache = {'h': (B,H,N,P), 'conv': (B,conv-1,conv_dim)},
    updated in place. A one-token call WITH a cache takes the recurrent
    update; any other call the chunked form, its length zero-padded to a
    multiple of the chunk (dt = 0 there: the padded steps neither decay
    nor feed the state).

    Under a mesh x is split by batch and `in_proj` by its columns over
    'model', at a boundary that falls inside one of the fused parts
    z | x | B | C | dt. The fused output is gathered along its columns
    (`nn.split_last`; each part's gradient, a pending sum over the heads'
    split, is added up where it meets the gather), so the parts, the conv
    window (its kernel gathered, `nn.causal_conv`) and B, C are whole on
    every rank; x is then split over heads as the
    reference's `shard(xi, "batch", None, "heads", None)` asks, and each
    rank scans its own heads (`_mamba_heads`). The state `h` is written in
    the cache's layout (gathered over the heads where `cache_sharding`
    keeps it whole), the gated output goes through the split `out_norm`
    and the row-parallel `out_proj`."""
    s: SSMCfg = cfg.ssm
    b, l, d = x.shape
    d_in = s.expand * d
    nh = d_in // s.head_dim
    g, n = s.n_groups, s.state
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = dense(xn, p["in_proj"])
    z, xi, BC, dt_raw = nn.split_last(zxbcdt, d_in, d_in, 2 * g * n, nh)
    conv_in = nn.cat([xi, BC], -1)  # (b, l, conv_dim)
    conv_out, new_conv = causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                     None if cache is None else cache["conv"])
    xi, Bm, Cm = nn.split_last(conv_out, d_in, g * n, g * n)
    xi = nn.on_shards(lambda t: t.reshape(t.shape[0], l, nh, s.head_dim), xi,
                      (b, l, nh, s.head_dim))
    xi = shard(xi, "batch", None, "heads", None)
    h0 = None if cache is None else cache["h"]
    if nn.is_sharded(xi):
        y, h_final = _mamba_heads_sharded(p, xi, z, Bm, Cm, dt_raw, h0, s)
    else:
        y, h_final = _mamba_heads(xi, z, Bm, Cm, dt_raw, p["A_log"], p["D"], p["dt_bias"],
                                  None if h0 is None else h0.to(x.dtype), s,
                                  decode=cache is not None)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"])
    new_cache = None
    if cache is not None:
        nn.write_state(cache["h"], h_final)
        nn.write_state(cache["conv"], new_conv)
        new_cache = {"h": cache["h"], "conv": cache["conv"]}
    return out, new_cache


def _mamba_heads(xi, z, Bm, Cm, dt_raw, A_log, D, dt_bias, h0, s: SSMCfg, decode: bool):
    """The scan of `apply_mamba` on plain tensors, for the heads that `xi`
    (B, L, h, P), `dt_raw` (B, L, h), `A_log`, `D`, `dt_bias` (h,), `h0`
    (B, h, N, P, in the compute dtype, or None) and the gate `z`
    (B, L, h * P) hold; B and C (B, L, N) are shared by every head. A
    one-token call with a state takes the recurrent update (`decode`).
    Returns (the gated output (B, L, h * P), the final state)."""
    b, l, h, hp = xi.shape
    dtype = xi.dtype
    dt = _softplus(dt_raw.to(torch.float32) + dt_bias.to(torch.float32))
    A = -torch.exp(A_log.to(torch.float32))
    if l == 1 and decode:
        # recurrent decode: h = exp(dt A) h + dt B (x) x ; y = C h + D x
        a = torch.exp(dt[:, 0] * A)  # (b, h)
        bx = torch.einsum("bn,bhp->bhnp", Bm[:, 0], xi[:, 0] * dt[:, 0, :, None].to(dtype))
        hn = h0 * a[..., None, None].to(dtype) + bx.to(dtype)
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0], hn)[:, None]
        y = y.reshape(b, 1, h, hp)
        h_final = hn
    else:
        pad = (-l) % s.chunk
        if pad:
            xi = F.pad(xi, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        y, h_final = ssd_chunked(xi, dt, A, Bm, Cm, s.chunk, h0)
        y = y[:, :l]
        xi = xi[:, :l]
    y = y + xi * D.to(dtype)[None, None, :, None]
    y = y.reshape(b, l, h * hp)
    return y * F.silu(z.to(torch.float32)).to(dtype), h_final  # gated


def _mamba_heads_sharded(p, xi, z, Bm, Cm, dt_raw, h0, s: SSMCfg):
    """`_mamba_heads` on each rank's rows and heads: `xi` (B, L, H, P) is
    split by batch and heads, the other inputs whole over the head split
    (each rank takes its heads' part of `z`, `dt_raw` and the per-head
    params, and reads B and C whole: their gradients are pending sums over
    the ranks of the split). The state `h0` (a cache) is taken in the
    heads' layout. Returns the gated output (B, L, H * P) and the final
    state (B, H, N, P) as DTensors split like `xi`."""
    from torch.distributed.tensor import Shard

    b, l, nh, hp = xi.shape
    split = nn.split_mesh_dims(xi)
    start, stop = nn._box(xi)
    h_lo, h_hi = start[2], stop[2]
    state = tuple(Shard(1) if pl == Shard(2) else pl for pl in xi.placements)
    heads = slice(h_lo, h_hi)
    if h0 is not None:
        from ..runtime import sharding as rsh

        h0 = rsh.redistribute(h0.detach(), state).to_local().to(xi.dtype)
    y, h_final = _mamba_heads(
        xi.to_local(), nn.local_part(z, split)[..., h_lo * hp:h_hi * hp],
        nn.local_part(Bm, split), nn.local_part(Cm, split),
        nn.local_part(dt_raw, split)[..., heads],
        *(nn.local_part(p[k], split)[heads] for k in ("A_log", "D", "dt_bias")),
        h0, s, decode=h0 is not None)
    from ..runtime import sharding as rsh

    lay = rsh.NamedSharding(xi.device_mesh, state)
    return (nn._like(y, xi, (b, l, nh * hp)),
            rsh.from_local(h_final.contiguous(), lay, (b, nh) + tuple(h_final.shape[2:])))


def mamba_cache_desc(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32) -> dict:
    s: SSMCfg = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state
    return {
        "h": TensorSpec((batch, nh, s.state, s.head_dim), dtype),
        "conv": TensorSpec((batch, s.conv - 1, conv_dim), dtype),
    }
