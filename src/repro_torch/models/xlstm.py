"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, recurrent loop), in torch.

Port of `repro.models.xlstm`. It follows the xLSTM paper's stabilized
exponential gating; the mLSTM uses a chunkwise form (like SSD), so
prefill is parallel within a chunk and decode is an O(1)-state update.
The chunk recurrence and the sLSTM's time recurrence are Python loops.

Caches are written IN PLACE (as `blocks.apply_attn`'s): the returned
cache holds the given tensors with the new state. The mLSTM's conv cache
is bfloat16 whatever the compute dtype, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import nn
from .config import ModelConfig, XLSTMCfg
from .nn import P, TensorSpec, causal_conv, dense, rms_norm, shard

#: the mLSTM stabilizer's start value (the reference's stand-in for -inf)
M_INIT = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def desc_mlstm(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    xc: XLSTMCfg = cfg.xlstm
    d_in = int(xc.proj_factor * d)
    nh = cfg.n_heads
    return {
        "norm": P((d,), ("norm",), "ones"),
        "w_up": P((d, d_in), ("embed", "mlp")),
        "w_gate": P((d, d_in), ("embed", "mlp")),
        "conv_w": P((4, d_in), (None, "mlp")),
        "conv_b": P((d_in,), ("mlp",), "zeros"),
        "wq": P((d_in, d_in), ("mlp", "heads")),
        "wk": P((d_in, d_in), ("mlp", "heads")),
        "wv": P((d_in, d_in), ("mlp", "heads")),
        "w_if": P((d_in, 2 * nh), ("mlp", None), scale=0.01),
        "if_bias": P((2 * nh,), (None,), "zeros"),
        "out_norm": P((d_in,), ("norm",), "ones"),
        "w_down": P((d_in, d), ("mlp", "embed")),
    }


def _mlstm_chunked(q, k, v, ig, lf, chunk, state=None):
    """Stabilized chunkwise mLSTM.

    q/k/v: (B, L, H, D); ig (input gate logit), lf (log forget gate): (B, L, H).
    state: (C (B,H,D,D), n (B,H,D), m (B,H)) or None.
    Returns y (B,L,H,D), new state.
    """
    b, l, h, dk = q.shape
    nc = l // chunk
    f32 = torch.float32
    dev = q.device
    qc = q.reshape(b, nc, chunk, h, dk)
    kc = k.reshape(b, nc, chunk, h, dk)
    vc = v.reshape(b, nc, chunk, h, dk)
    igc = torch.movedim(ig.reshape(b, nc, chunk, h), -1, 2)  # (b,nc,h,q)
    lfc = torch.movedim(lf.reshape(b, nc, chunk, h), -1, 2)
    cum = torch.cumsum(lfc, dim=-1)  # (b,nc,h,q)
    if state is None:
        C0 = torch.zeros((b, h, dk, dk), dtype=f32, device=dev)
        n0 = torch.zeros((b, h, dk), dtype=f32, device=dev)
        m0 = torch.full((b, h), M_INIT, dtype=f32, device=dev)
    else:
        C0, n0, m0 = state

    # intra-chunk log weights D[t,s] = cum_t - cum_s + ig_s  (s <= t)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    Dlog = cum[..., :, None] - cum[..., None, :] + igc[..., None, :]
    Dlog = torch.where(tri, Dlog, -torch.inf)  # (b,nc,h,q,q)
    m_intra = torch.amax(Dlog, dim=-1)  # (b,nc,h,q)

    # chunk-local state contributions, for all chunks at once
    cum_end = cum[..., -1]  # (b,nc,h)
    w_end = cum_end[..., None] - cum + igc  # (b,nc,h,q)
    m_loc = torch.amax(w_end, dim=-1)  # (b,nc,h)
    wgt = torch.exp(w_end - m_loc[..., None]).to(f32)
    KV_loc = torch.einsum("bchs,bcshd,bcshe->bchde", wgt, kc.to(f32), vc.to(f32))
    n_loc = torch.einsum("bchs,bcshd->bchd", wgt, kc.to(f32))

    # the recurrence over chunks; each chunk reads the state before it
    C, n, m = C0, n0, m0
    C_prev, n_prev, m_prev = [], [], []
    for c in range(nc):
        C_prev.append(C)
        n_prev.append(n)
        m_prev.append(m)
        dec, mloc = cum_end[:, c], m_loc[:, c]
        m_new = torch.maximum(m + dec, mloc)
        sc_old = torch.exp(m + dec - m_new)
        sc_loc = torch.exp(mloc - m_new)
        C = C * sc_old[..., None, None] + KV_loc[:, c] * sc_loc[..., None, None]
        n = n * sc_old[..., None] + n_loc[:, c] * sc_loc[..., None]
        m = m_new
    C_prev = torch.stack(C_prev, dim=1)  # (b,nc,h,dk,dv)
    n_prev = torch.stack(n_prev, dim=1)  # (b,nc,h,dk)
    m_prev = torch.stack(m_prev, dim=1)  # (b,nc,h)

    # per-step stabilizer and outputs, for all chunks at once
    m_t = torch.maximum(m_prev[..., None] + cum, m_intra)  # (b,nc,h,q)
    inter_w = torch.exp(cum + m_prev[..., None] - m_t)  # (b,nc,h,q)
    intra_w = torch.exp(Dlog - m_t[..., None])  # (b,nc,h,q,q)
    # the scores in the inputs' dtype, as the reference
    qk = torch.einsum("bcthd,bcshd->bchts", qc, kc) / math.sqrt(dk)
    Wts = intra_w * qk.to(f32)
    num = torch.einsum("bchts,bcshd->bcthd", Wts, vc.to(f32))
    num = num + torch.einsum(
        "bcthd,bchde,bcht->bcthe", qc.to(f32), C_prev, inter_w
    ) / math.sqrt(dk)
    qn = torch.einsum("bcthd,bchd->bcht", qc.to(f32), n_prev) / math.sqrt(dk)
    den = torch.sum(Wts, dim=-1) + qn * inter_w  # (b,nc,h,q)
    den = torch.maximum(torch.abs(den), torch.exp(-m_t))
    # num: (b,nc,t,h,d); den: (b,nc,h,t) -> (b,nc,t,h)
    y = num / den.permute(0, 1, 3, 2)[..., None]
    y = y.to(q.dtype).reshape(b, l, h, dk)
    return y, (C, n, m)


def mlstm_decode_step(q, k, v, ig, lf, state):
    """One-token recurrent mLSTM update. q/k/v: (B,H,D); ig/lf: (B,H)."""
    C, n, m = state
    dk = q.shape[-1]
    f32 = torch.float32
    m_new = torch.maximum(lf + m, ig)
    fw = torch.exp(lf + m - m_new)[..., None]
    iw = torch.exp(ig - m_new)[..., None]
    kf = k.to(f32)
    vf = v.to(f32)
    Cn = C * fw[..., None] + iw[..., None] * kf[..., :, None] * vf[..., None, :]
    nn_ = n * fw + iw * kf
    qf = q.to(f32) / math.sqrt(dk)
    num = torch.einsum("bhd,bhde->bhe", qf, Cn)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, nn_)), torch.exp(-m_new))
    y = (num / den[..., None]).to(q.dtype)
    return y, (Cn, nn_, m_new)


def apply_mlstm(p, x, cfg: ModelConfig, *, cache=None):
    """mLSTM block. cache = {'C': (B,H,D,D), 'n': (B,H,D), 'm': (B,H),
    'conv': (B,3,d_in) bfloat16}, updated in place. A one-token call WITH
    a cache takes the recurrent update; any other call the chunked form,
    its length padded to a multiple of the chunk (input gate -1e30 and
    log forget gate 0 there, so the state passes the padding unchanged).

    Under a mesh x is split by batch: `w_up` and `w_gate` are
    column-parallel over 'model' and the conv runs on each rank's
    channels; `wq`, `wk`, `wv` and `w_if` take their rows' split
    (row-parallel, a float32 pending sum rounded once), so q, k and v come
    out whole and are split over heads (the reference's
    `shard(q, "batch", None, "heads", None)`); each rank runs the chunked
    form or the decode step on its own heads (`_mlstm_heads`), with its
    heads' part of the gates and of the states C, n, m."""
    xc: XLSTMCfg = cfg.xlstm
    b, l, d = x.shape
    d_in = int(xc.proj_factor * d)
    nh = cfg.n_heads
    dk = d_in // nh
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    u = dense(xn, p["w_up"])
    gate = dense(xn, p["w_gate"])
    cu, new_conv = causal_conv(u, p["conv_w"], p["conv_b"], None if cache is None else cache["conv"])

    def heads(t):
        t = nn.on_shards(lambda a: a.reshape(a.shape[0], l, nh, dk), t, (b, l, nh, dk))
        return shard(t, "batch", None, "heads", None)

    q = heads(dense(cu, p["wq"]))
    k = heads(dense(cu, p["wk"]))
    v = heads(dense(u, p["wv"]))
    gates = dense(cu, p["w_if"])
    state = None
    if cache is not None:
        state = (cache["C"], cache["n"], cache["m"])
    if nn.is_sharded(q):
        from ..runtime import sharding as rsh

        y, new_state = _mlstm_heads_sharded(q, k, v, gates, p["if_bias"], state, xc.chunk)
        gate = rsh.redistribute(gate, tuple(y.placements))  # y's columns are its heads
    else:
        y, new_state = _mlstm_heads(q, k, v, gates, p["if_bias"], state, xc.chunk, slice(0, nh))
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    y = y * F.silu(gate.to(torch.float32)).to(y.dtype)
    out = dense(y, p["w_down"])
    new_cache = None
    if cache is not None:
        for key, t in zip(("C", "n", "m"), new_state):
            nn.write_state(cache[key], t)
        nn.write_state(cache["conv"], new_conv)
        new_cache = {key: cache[key] for key in ("C", "n", "m", "conv")}
    return out, new_cache


def _mlstm_heads(q, k, v, gates, if_bias, state, chunk: int, heads: slice):
    """The mLSTM of `apply_mlstm` on plain tensors, for the heads `heads`
    of the (B, L, 2 * H) gate logits (`gates` before `if_bias`, in the
    compute dtype) that q, k, v (B, L, h, D) and the state (C, n, m) hold:
    the decode step for one token with a state, else the chunked form.
    Returns (y (B, L, h * D), the new state)."""
    b, l, h, dk = q.shape
    nh = gates.shape[-1] // 2
    g = gates.to(torch.float32) + if_bias.to(torch.float32)
    ig, fg = g[..., :nh][..., heads], g[..., nh:][..., heads]
    lf = F.logsigmoid(fg)
    if l == 1 and state is not None:
        y, new_state = mlstm_decode_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], lf[:, 0], state)
        y = y[:, None]
    else:
        pad = (-l) % chunk
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, pad))
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            ig = F.pad(ig, (0, 0, 0, pad), value=M_INIT)
            lf = F.pad(lf, (0, 0, 0, pad))
        y, new_state = _mlstm_chunked(q, k, v, ig, lf, chunk, state)
        y = y[:, :l]
    return y.reshape(b, l, h * dk), new_state


def _mlstm_heads_sharded(q, k, v, gates, if_bias, state, chunk: int):
    """`_mlstm_heads` on each rank's rows and heads: q, k, v split by batch
    and heads, the gate logits and `if_bias` whole over the head split
    (each rank takes its heads' columns; their gradients are pending sums
    over the split), the state (a cache) taken in the heads' layout.
    Returns y (B, L, H * D) split like q, and the new state as DTensors."""
    from torch.distributed.tensor import Shard

    from ..runtime import sharding as rsh

    b, l, nh, dk = q.shape
    split = nn.split_mesh_dims(q)
    start, stop = nn._box(q)
    lay = tuple(Shard(1) if pl == Shard(2) else pl for pl in q.placements)
    if state is not None:
        state = tuple(rsh.redistribute(t.detach(), lay).to_local() for t in state)
    y, new_state = _mlstm_heads(q.to_local(), k.to_local(), v.to_local(),
                                nn.local_part(gates, split), nn.local_part(if_bias, split),
                                state, chunk, slice(start[2], stop[2]))
    named = rsh.NamedSharding(q.device_mesh, lay)
    full = ((b, nh, dk, dk), (b, nh, dk), (b, nh))
    return (nn._like(y, q, (b, l, nh * dk)),
            tuple(rsh.from_local(t.contiguous(), named, f) for t, f in zip(new_state, full)))


def mlstm_cache_desc(cfg: ModelConfig, batch: int) -> dict:
    xc: XLSTMCfg = cfg.xlstm
    d_in = int(xc.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    dk = d_in // nh
    return {
        "C": TensorSpec((batch, nh, dk, dk), torch.float32),
        "n": TensorSpec((batch, nh, dk), torch.float32),
        "m": TensorSpec((batch, nh), torch.float32),
        "conv": TensorSpec((batch, 3, d_in), torch.bfloat16),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def desc_slstm(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    return {
        "norm": P((d,), ("norm",), "ones"),
        "w_in": P((d, 4 * d), ("embed", "mlp")),
        "r": P((nh, hd, 4 * hd), (None, None, None), scale=1.0 / math.sqrt(hd)),
        "bias": P((4 * d,), (None,), "zeros"),
        "out_norm": P((d,), ("norm",), "ones"),
        "w_out": P((d, d), ("mlp", "embed")),
    }


def apply_slstm(p, x, cfg: ModelConfig, *, cache=None):
    """sLSTM with exponential gating and per-head recurrent mixing.

    cache = {'c','n','m','h': (B, NH, HD)}, updated in place; a loop over
    time for l > 1.

    Under a mesh x is split by batch and `w_in` by its columns over
    'model', on whole heads where the heads divide (else its output is
    gathered): each rank runs the recurrence of its own heads with its
    heads' slice of the bias and of the whole `r` (their gradients pending
    sums over the ranks that read other heads), then the split
    `out_norm` and the row-parallel `w_out`.
    """
    b, l, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    wx = dense(xn, p["w_in"])
    state = None if cache is None else tuple(cache[k] for k in ("c", "n", "m", "h"))
    if nn.is_sharded(wx):
        y, new_state = _slstm_heads_sharded(wx, p["bias"], p["r"], state, nh)
    else:
        y, new_state = _slstm_heads(wx.reshape(b, l, nh, 4 * hd), p["bias"], p["r"], state,
                                    slice(0, nh))
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = dense(y, p["w_out"])
    new_cache = None
    if cache is not None:
        for key, t in zip(("c", "n", "m", "h"), new_state):
            nn.write_state(cache[key], t)
        new_cache = {key: cache[key] for key in ("c", "n", "m", "h")}
    return out, new_cache


def _slstm_heads(wx, bias, r, state, heads: slice):
    """The sLSTM recurrence of `apply_slstm` on plain tensors, for the
    heads `heads` that `wx` (B, L, h, 4 * HD, before the bias) and the
    state (c, n, m, h, or None for zeros) hold. Returns (y (B, L, h * HD)
    in the dtype of `wx`, the new state in float32)."""
    b, l, h_loc, f4 = wx.shape
    hd = f4 // 4
    f32 = torch.float32
    wx = wx + bias.to(wx.dtype).reshape(-1, f4)[heads]
    if state is not None:
        c, n, m, h = (t.to(f32) for t in state)
    else:
        # m starts at zeros, as the zeros cache does
        c, n, m, h = (torch.zeros((b, h_loc, hd), dtype=f32, device=wx.device) for _ in range(4))
    rmat = r.to(f32)[heads]
    hs = []
    for t in range(l):
        z = wx[:, t].to(f32) + torch.einsum("bhd,hdf->bhf", h, rmat)
        zi, ii, ff, oo = torch.split(z, hd, dim=-1)
        m_new = torch.maximum(ff + m, ii)
        i_p = torch.exp(ii - m_new)
        f_p = torch.exp(ff + m - m_new)
        c = f_p * c + i_p * torch.tanh(zi)
        n = f_p * n + i_p
        h = torch.sigmoid(oo) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, l, h_loc * hd).to(wx.dtype)
    return y, (c, n, m, h)


def _slstm_heads_sharded(wx, bias, r, state, nh: int):
    """`_slstm_heads` on each rank's rows and heads: `wx` (B, L, 4d) split
    by batch and over 'model' on whole heads (gathered where the split
    cuts a head), `bias` and `r` whole (each rank takes its heads' part:
    their gradients are pending sums over the split), the state (a cache)
    taken in the heads' layout. Returns y (B, L, d) and the new state,
    DTensors split by batch and heads."""
    from torch.distributed.tensor import Replicate, Shard

    from ..runtime import sharding as rsh

    b, l, f = wx.shape
    cols = nn._split_dims(wx, 2)
    if cols and nh % math.prod(wx.device_mesh.size(j) for j in cols):
        wx = rsh.redistribute(wx, tuple(Replicate() if j in cols else pl
                                        for j, pl in enumerate(wx.placements)))
    start, stop = nn._box(wx)
    f4 = f // nh
    heads = slice(start[2] // f4, stop[2] // f4)
    split = nn.split_mesh_dims(wx)
    lay = tuple(Shard(1) if pl == Shard(2) else pl for pl in wx.placements)
    if state is not None:
        state = tuple(rsh.redistribute(t.detach(), lay).to_local() for t in state)
    local = wx.to_local()
    y, new_state = _slstm_heads(local.reshape(local.shape[0], l, -1, f4),
                                nn.local_part(bias, split), nn.local_part(r, split), state, heads)
    named = rsh.NamedSharding(wx.device_mesh, lay)
    return (nn._like(y, wx, (b, l, f // 4)),
            tuple(rsh.from_local(t.contiguous(), named, (b, nh, f4 // 4)) for t in new_state))


def slstm_cache_desc(cfg: ModelConfig, batch: int) -> dict:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    sd = TensorSpec((batch, nh, hd), torch.float32)
    return {"c": sd, "n": sd, "m": sd, "h": sd}
