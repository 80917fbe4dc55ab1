"""Transformer building blocks: GQA attention with its three decode caches,
MLA (multi-head latent attention), the dense MLPs and the MoE block, in
torch.

Port of `repro.models.blocks`. Every block exposes `desc_*` (a
P-descriptor tree) and `apply_*` (plain torch). Decode caches are dicts
of tensors; `*_cache_desc` gives their `TensorSpec`s.

Decode caches are written IN PLACE: where the reference returns a
functionally updated array (`dynamic_update_slice`, `.at[].set`), the port
writes the new keys and values into the cache tensor it was given and
returns that same tensor. The caller keeps the returned cache and reads
no older copy.

The MoE block is deterministic on the card: its top-k breaks ties toward
the lower expert index and its combine adds in a fixed order (see
`apply_moe`), so two runs on the same inputs agree bit for bit.

Under a mesh (`runtime.sharding.activate`) every block takes DTensors:
GQA and MLA run on each rank's rows and heads, the MoE on each rank's
tokens and experts with the global routing (`_moe_sharded`).
"""

from __future__ import annotations

import math

import torch

from . import nn
from .config import MLACfg, ModelConfig
from .nn import P, TensorSpec, attention, dense, rms_norm, rope, shard


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def desc_attn(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    return {
        "norm": P((d,), ("norm",), "ones"),
        "wq": P((d, h * dh), ("embed", "heads")),
        "wk": P((d, hkv * dh), ("embed", "heads")),
        "wv": P((d, hkv * dh), ("embed", "heads")),
        "wo": P((h * dh, d), ("heads", "embed")),
    }


def apply_attn(
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int | None = None,
    cache: dict | None = None,
    memory: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Self- or cross-attention with an optional decode cache.

    memory: the encoder's output (B, M, d_model), already normed, for
    cross-attention: the queries come from the normed `x`, the keys and
    values from `memory` as it is, with no rope, no mask and no cache (a
    decode step recomputes them from `memory`, as the reference does).

    Contiguous cache: {'k': (B, M, Hkv, Dh), 'v': ..., 'len': ()} (plus
    'k_scale'/'v_scale' (B, M, Hkv) for the int8 cache), written at
    position `len` (a ring buffer of M slots); attention masked to len+L.

    Paged cache (serving tier, DESIGN.md §9): {'k': (P, T, Hkv, Dh) page
    arena, 'v': ..., 'len': (B,) per-slot clocks, 'ptab': (B, max_pages)
    arena page ids}. Decode-only (L == 1): the new token scatters into
    page ``ptab[b, len[b] // T]`` row ``len[b] % T`` and attention reads
    the slot's whole context gathered through its page table. Dead slots
    (table rows of 0) all write row 0 of the scratch page 0: a scatter with
    repeated indices whose winner no live slot reads.
    """
    b, l, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = nn.split_heads(dense(xn, p["wq"]), h, dh)
    src = xn if memory is None else memory  # the encoder memory is pre-normed
    k = nn.split_heads(dense(src, p["wk"]), hkv, dh)
    v = nn.split_heads(dense(src, p["wv"]), hkv, dh)
    if memory is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    new_cache = None
    if memory is not None:
        out = attention(q, k, v, causal=False, window=window)
    elif cache is not None and "ptab" in cache:
        # --- paged KV pool (serving tier, DESIGN.md §9) ---
        if nn.is_sharded(q):
            raise NotImplementedError(
                "the paged KV pool under a mesh: the reference never runs it under a mesh "
                "(its run_continuous returns before it makes one)")
        if l != 1:
            raise ValueError(
                "paged KV cache is decode-only (L == 1); prefill runs "
                "against a contiguous sub-cache and is spliced into the "
                "arena by the batcher (runtime/batcher.py)"
            )
        lens = cache["len"].long()  # (B,) per-slot clocks
        ptab = cache["ptab"].long()  # (B, max_pages) arena page ids
        ck, cv = cache["k"], cache["v"]
        pt = ck.shape[1]
        pid = torch.gather(ptab, 1, (lens // pt)[:, None])[:, 0]
        off = torch.remainder(lens, pt)
        ck[pid, off] = k[:, 0].to(ck.dtype)
        cv[pid, off] = v[:, 0].to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        k_all = ck[ptab].reshape(b, -1, hkv, dh).to(q.dtype)
        v_all = cv[ptab].reshape(b, -1, hkv, dh).to(q.dtype)
        out = attention(
            q, k_all, v_all, causal=causal, q_offset=lens, window=window, kv_len=lens + l
        )
    elif cache is not None:
        pos = cache["len"]
        m_cap = cache["k"].shape[1]
        # ring buffer (windowed long-context decode); like
        # dynamic_update_slice, the start is clamped so the L rows fit
        start = torch.clamp(torch.remainder(pos, m_cap), max=m_cap - l)
        rows = start.long() + torch.arange(l, device=x.device)
        ck, cv = cache["k"], cache["v"]
        if "k_scale" in cache:
            # int8 KV cache: per-(token, head) linear quantization (the
            # paper's Stage-II vector quantization applied to KV residency)
            kq, ks = _quantize(k)
            vq, vs = _quantize(v)
            cks, cvs = cache["k_scale"], cache["v_scale"]
            for dst, new in ((ck, kq), (cv, vq), (cks, ks), (cvs, vs)):
                nn.write_rows(dst, rows, new)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs, "len": pos + l}
            k_all = _dequantize(ck, cks, q.dtype)
            v_all = _dequantize(cv, cvs, q.dtype)
        else:
            nn.write_rows(ck, rows, k.to(ck.dtype))
            nn.write_rows(cv, rows, v.to(cv.dtype))
            new_cache = {"k": ck, "v": cv, "len": pos + l}
            k_all, v_all = ck.to(q.dtype), cv.to(q.dtype)
        out = attention(
            q, k_all, v_all, causal=causal, q_offset=torch.clamp(pos, max=m_cap - l),
            window=window, kv_len=torch.clamp(pos + l, max=m_cap),
        )
    else:
        out = attention(q, k, v, causal=causal, window=window)
    out = out.reshape(b, l, h * dh)
    return dense(out, p["wo"]), new_cache


def _quantize(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scales) of keys or values (B, L, H, Dh): one
    scale per (token, head), max|t| over Dh / 127. Under a mesh each rank
    quantizes its own rows and heads (no rule splits Dh): the codes are
    laid out as `t`, the scales as `t` without its last dim."""
    def quantize(x):
        scale = torch.amax(torch.abs(x), dim=-1).to(torch.float32) / 127.0 + 1e-12
        return torch.round(x.to(torch.float32) / scale[..., None]).to(torch.int8), scale

    if not nn.is_sharded(t):
        return quantize(t)
    codes, scale = quantize(t.to_local())
    return nn._like(codes, t, t.shape), nn._like(scale, t, t.shape[:-1])


def _dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """codes (B, M, H, Dh) times their scales (B, M, H), in `dtype`. Under a
    mesh the scales are laid out as the codes (`cache_sharding` places both
    by the same sizes) and each rank scales its own shard."""
    if not nn.is_sharded(codes):
        return codes.to(dtype) * scale[..., None].to(dtype)
    from ..runtime import sharding as rsh

    scale = rsh.redistribute(scale, tuple(codes.placements))
    local = codes.to_local().to(dtype) * scale.to_local()[..., None].to(dtype)
    return nn._like(local, codes, codes.shape)


def attn_cache_desc(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    hkv, dh = cfg.n_kv_heads, cfg.dh
    if cfg.kv_quant:
        return {
            "k": TensorSpec((batch, max_len, hkv, dh), torch.int8),
            "v": TensorSpec((batch, max_len, hkv, dh), torch.int8),
            "k_scale": TensorSpec((batch, max_len, hkv), torch.float32),
            "v_scale": TensorSpec((batch, max_len, hkv), torch.float32),
            "len": TensorSpec((), torch.int32),
        }
    return {
        "k": TensorSpec((batch, max_len, hkv, dh), dtype),
        "v": TensorSpec((batch, max_len, hkv, dh), dtype),
        "len": TensorSpec((), torch.int32),
    }


def paged_attn_cache_desc(cfg: ModelConfig, pages: int, page_tokens: int,
                          dtype: torch.dtype = torch.bfloat16) -> dict:
    """Per-layer page-arena specs (serving tier, DESIGN.md §9): `pages`
    usable pages of `page_tokens` tokens, plus the reserved scratch page 0
    that dead slots write into (the allocator hands out ids 1..pages). The
    per-slot clock/table state lives at the cache's top level
    (`model.paged_cache_desc`), not per layer."""
    if cfg.kv_quant:
        raise NotImplementedError("paged KV pool does not support the int8 quantized cache yet")
    hkv, dh = cfg.n_kv_heads, cfg.dh
    return {
        "k": TensorSpec((pages + 1, page_tokens, hkv, dh), dtype),
        "v": TensorSpec((pages + 1, page_tokens, hkv, dh), dtype),
    }


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def desc_mla(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    m: MLACfg = cfg.mla
    return {
        "norm": P((d,), ("norm",), "ones"),
        "wq_a": P((d, m.q_lora), ("embed", None)),
        "q_norm": P((m.q_lora,), ("norm",), "ones"),
        "wq_b": P((m.q_lora, h * (m.qk_nope + m.qk_rope)), (None, "heads")),
        "wkv_a": P((d, m.kv_lora + m.qk_rope), ("embed", None)),
        "kv_norm": P((m.kv_lora,), ("norm",), "ones"),
        "wkv_b": P((m.kv_lora, h * (m.qk_nope + m.v_head)), (None, "heads")),
        "wo": P((h * m.v_head, d), ("heads", "embed")),
    }


def apply_mla(
    p: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """MLA attention. The cache holds only the compressed latent: {'ckv':
    (B, M, kv_lora), 'krope': (B, M, qk_rope), 'len': ()}.

    With a cache (decode, and a prefill into a cache) the reference's
    absorbed form runs: W_uk is folded into q and W_uv applied after the
    contraction, so attention scores and contracts in the kv_lora latent
    space and K/V are never materialized for the context. The L new rows
    are written at ``min(len, M - L)`` (`dynamic_update_slice` clamps; no
    ring buffer), `kv_norm` is applied to the whole cached latent, and the
    mask is ``kpos <= len + i`` and ``kpos < len + L``. Without a cache
    (training, parallel forward) K and V are materialized: q and k are
    qk_nope + qk_rope wide, v is v_head wide.

    Under a mesh x is split by batch; `wq_b` and `wkv_b` are split by
    heads over 'model' (column-parallel), so q, K and V come out on each
    rank's heads (`nn.split_heads`); the shared rope key (B, L, 1, r) and
    the latent cache, which have no head dim, are whole over 'model' and
    are widened to the local heads only; `wo` is row-parallel.
    """
    b, l, d = x.shape
    h = cfg.n_heads
    m: MLACfg = cfg.mla
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = dense(rms_norm(dense(xn, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    q = nn.split_heads(q, h, m.qk_nope + m.qk_rope)
    q_nope, q_rope = nn.split_last(q, m.qk_nope, m.qk_rope)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv_a = dense(xn, p["wkv_a"])
    c_kv, k_rope = nn.split_last(kv_a, m.kv_lora, m.qk_rope)
    k_rope = nn.on_shards(lambda t: t[:, :, None, :], k_rope, (b, l, 1, m.qk_rope))
    k_rope = rope(k_rope, positions, cfg.rope_theta)  # (B, L, 1, r)
    if cache is not None:
        # --- absorbed MLA decode: score and contract in the latent space ---
        pos = cache["len"]
        cc, cr = cache["ckv"], cache["krope"]
        mcap = cc.shape[1]
        rows = torch.clamp(pos, min=0, max=mcap - l).long() + torch.arange(l, device=x.device)
        nn.write_rows(cc, rows, c_kv.to(cc.dtype))
        nn.write_rows(cr, rows, nn.on_shards(lambda t: t[:, :, 0, :], k_rope,
                                             (b, l, m.qk_rope)).to(cr.dtype))
        new_cache = {"ckv": cc, "krope": cr, "len": pos + l}
        c_all = rms_norm(cc.to(x.dtype), p["kv_norm"], cfg.norm_eps)  # (B, M, r)
        kr_all = cr.to(x.dtype)  # (B, M, rope)
        if nn.is_sharded(q_nope):
            out = _absorbed_sharded(q_nope, q_rope, c_all, kr_all, p["wkv_b"], pos, l, cfg)
        else:
            wkv = p["wkv_b"].reshape(m.kv_lora, h, m.qk_nope + m.v_head).to(x.dtype)
            out = _absorbed(q_nope, q_rope, c_all, kr_all, wkv, pos, l, cfg)
        return dense(out.reshape(b, l, h * m.v_head), p["wo"]), new_cache
    # --- parallel path (train / no cache): materialized K/V ---
    kv = dense(rms_norm(c_kv, p["kv_norm"], cfg.norm_eps), p["wkv_b"])
    kv = nn.split_heads(kv, h, m.qk_nope + m.v_head)
    k_nope, v = nn.split_last(kv, m.qk_nope, m.v_head)
    k = _with_rope_key(k_nope, k_rope)
    qq = nn.cat([q_nope, q_rope], -1)
    qq = shard(qq, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    out = attention(qq, k, v, causal=True)  # scaled by 1/sqrt(qk_nope + qk_rope)
    return dense(out.reshape(b, l, h * m.v_head), p["wo"]), None


def _absorbed(q_nope, q_rope, c_all, kr_all, wkv, pos, l: int, cfg: ModelConfig):
    """The absorbed attention on plain tensors: queries (B, L, H, ·) of H
    heads, the normed latent (B, M, kv_lora) and rope keys (B, M, r), and
    `wkv_b` as (kv_lora, H, qk_nope + v_head) in the compute dtype; the
    context (B, L, H, v_head) before `wo`."""
    m: MLACfg = cfg.mla
    mcap = c_all.shape[1]
    w_uk, w_uv = wkv[..., : m.qk_nope], wkv[..., m.qk_nope:]
    q_lat = torch.einsum("blhn,rhn->blhr", q_nope, w_uk)  # absorb W_uk
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    logits = (
        torch.einsum("blhr,bmr->bhlm", q_lat, c_all)
        + torch.einsum("blhr,bmr->bhlm", q_rope, kr_all)
    ).to(torch.float32) * scale
    qpos = torch.arange(l, device=q_nope.device)[:, None] + pos
    kpos = torch.arange(mcap, device=q_nope.device)[None, :]
    mask = (kpos <= qpos) & (kpos < pos + l)
    logits = torch.where(mask[None, None], logits, -1e30)
    wts = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    ctx = torch.einsum("bhlm,bmr->blhr", wts, c_all)
    return torch.einsum("blhr,rhv->blhv", ctx, w_uv)  # deferred W_uv


def _absorbed_sharded(q_nope, q_rope, c_all, kr_all, wkv_b, pos, l: int, cfg: ModelConfig):
    """`_absorbed` on DTensors, on each rank's rows and heads: `wkv_b` laid
    out with the queries' head split (gathered where the heads do not
    divide it, as `nn.split_heads` gathers q), the latent whole over the
    head split. Each local operand declares its gradient's layout: the
    latent's and the weight's are pending sums over the mesh dims that
    split the heads and the batch, respectively."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..runtime import sharding as rsh

    m: MLACfg = cfg.mla
    heads = [j for j, pl in enumerate(q_nope.placements) if pl == Shard(2)]
    rows = [j for j, pl in enumerate(q_nope.placements) if pl == Shard(0)]
    want = tuple(Shard(1) if j in heads else Replicate() for j in range(len(q_nope.placements)))
    w = rsh.redistribute(wkv_b, want)
    wl = w.to_local(grad_placements=tuple(Partial() if j in rows else pl
                                          for j, pl in enumerate(want)))
    h_loc = q_nope.to_local().shape[2]
    wl = wl.reshape(m.kv_lora, h_loc, m.qk_nope + m.v_head).to(q_nope.dtype)

    shape = tuple(q_nope.shape[:3]) + (m.v_head,)
    seq = nn._split_dims(c_all, 1)
    if seq:
        out = _absorbed_split_k(q_nope, q_rope, c_all, kr_all, wl, pos, l, cfg, seq)
        return nn._like(out.contiguous(), q_nope, shape)

    def latent(t):
        return t.to_local(grad_placements=tuple(Partial() if j in heads else pl
                                                for j, pl in enumerate(t.placements)))

    out = _absorbed(q_nope.to_local(), q_rope.to_local(), latent(c_all), latent(kr_all), wl,
                    pos, l, cfg)
    return nn._like(out.contiguous(), q_nope, shape)


def _absorbed_split_k(q_nope, q_rope, c_all, kr_all, wl, pos, l: int, cfg: ModelConfig, seq):
    """`_absorbed` against a latent split along its rows over the mesh dims
    `seq` (a cache laid out by `cache_sharding(seq_shard=True)`, or one
    whose length matched a head count), serving only: each rank absorbs
    W_uk into its own heads' queries, gathers the absorbed queries and the
    rope queries over the heads' split in `seq`, scores its band of latent
    rows (masked in global positions), and the bands' partial softmaxes
    are combined over `seq` (`nn.combine_split_k`); each rank then applies
    W_uv to its own heads' context. The local context (B, L, H_loc,
    v_head)."""
    from torch.distributed.tensor import Replicate

    from ..runtime import sharding as rsh

    m: MLACfg = cfg.mla
    dt = q_nope.dtype
    w_uk, w_uv = wl[..., : m.qk_nope], wl[..., m.qk_nope:]
    q_lat = nn._like(torch.einsum("blhn,rhn->blhr", q_nope.to_local(), w_uk).contiguous(),
                     q_nope, tuple(q_nope.shape[:3]) + (m.kv_lora,))
    whole = tuple(Replicate() if j in seq else p for j, p in enumerate(q_nope.placements))
    q_lat, q_rope_g = rsh.redistribute(q_lat, whole), rsh.redistribute(q_rope, whole)
    c_loc, kr_loc = c_all.to_local(), kr_all.to_local()
    k0 = nn._box(c_all)[0][1]
    scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
    logits = (
        torch.einsum("blhr,bmr->bhlm", q_lat.to_local(), c_loc)
        + torch.einsum("blhr,bmr->bhlm", q_rope_g.to_local(), kr_loc)
    ).to(torch.float32) * scale
    dev = c_loc.device
    qpos = torch.arange(l, device=dev)[:, None] + pos
    kpos = k0 + torch.arange(c_loc.shape[1], device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos < pos + l)
    logits = torch.where(mask[None, None], logits, -1e30)
    top = torch.amax(logits, dim=-1)
    p = torch.exp(logits - top[..., None])
    ctx = torch.einsum("bhlm,bmr->blhr", p.to(dt), c_loc).to(torch.float32)
    ctx = nn.combine_split_k(ctx, top, p.sum(-1), c_all.device_mesh, seq).to(dt)
    # this rank's heads of the gathered context
    h0, g0 = nn._box(q_nope)[0][2], nn._box(q_lat)[0][2]
    ctx = ctx[:, :, h0 - g0:h0 - g0 + q_nope.to_local().shape[2]]
    return torch.einsum("blhr,rhv->blhv", ctx, w_uv)


def _with_rope_key(k_nope, k_rope):
    """The keys [k_nope, k_rope]: the shared rope key (B, L, 1, r) widened
    to the heads of k_nope (B, L, H, n). Under a mesh, to the local heads
    only; its gradient is then a pending sum over the mesh dims that split
    the heads."""
    if not nn.is_sharded(k_nope):
        b, l, h, _ = k_nope.shape
        return torch.cat([k_nope, k_rope.expand(b, l, h, k_rope.shape[-1])], dim=-1)
    from torch.distributed.tensor import Partial, Shard

    kn = k_nope.to_local()
    kr = k_rope.to_local(grad_placements=tuple(
        Partial() if pk == Shard(2) else pr for pk, pr in zip(k_nope.placements, k_rope.placements)))
    local = torch.cat([kn, kr.expand(*kn.shape[:3], kr.shape[-1])], dim=-1)
    return nn._like(local, k_nope, tuple(k_nope.shape[:3]) + (k_nope.shape[3] + k_rope.shape[3],))


def mla_cache_desc(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    m: MLACfg = cfg.mla
    return {
        "ckv": TensorSpec((batch, max_len, m.kv_lora), dtype),
        "krope": TensorSpec((batch, max_len, m.qk_rope), dtype),
        "len": TensorSpec((), torch.int32),
    }


# ---------------------------------------------------------------------------
# dense MLPs
# ---------------------------------------------------------------------------


def desc_mlp(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out = {"norm": P((cfg.d_model,), ("norm",), "ones")}
    if cfg.mlp_type == "swiglu":
        out |= {
            "w_gate": P((d, f), ("embed", "mlp")),
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed")),
        }
    else:
        out |= {
            "w_up": P((d, f), ("embed", "mlp")),
            "w_down": P((f, d), ("mlp", "embed")),
        }
    return out


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if cfg.mlp_type == "swiglu":
        return nn.swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.mlp_type == "relu2":
        return nn.relu2_mlp(xn, p["w_up"], p["w_down"])
    return nn.gelu_mlp(xn, p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def desc_moe(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    mo = cfg.moe
    e, f = mo.n_experts, mo.d_ff_expert
    out = {
        "norm": P((d,), ("norm",), "ones"),
        "router": P((d, e), ("embed", None), scale=0.02),
        "w_gate": P((e, d, f), ("experts", "embed", "mlp")),
        "w_up": P((e, d, f), ("experts", "embed", "mlp")),
        "w_down": P((e, f, d), ("experts", "mlp", "embed")),
    }
    if mo.n_shared:
        fs = mo.d_ff_shared or mo.d_ff_expert * mo.n_shared
        out["shared"] = {
            "w_gate": P((d, fs), ("embed", "mlp")),
            "w_up": P((d, fs), ("embed", "mlp")),
            "w_down": P((fs, d), ("mlp", "embed")),
        }
    return out


#: when a list, each `apply_moe` call appends its tokens' expert choices
#: (B, L, k) (a DTensor laid out by the batch split under a mesh), taken
#: from the routing it computes anyway: a probe for comparing the routing
#: of two runs. None (the default) records nothing.
ROUTING_LOG: list | None = None


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k token-choice routing with capacity; sort-based dispatch.

    Tokens split into `dispatch_groups` groups (1 when the count does not
    divide); within a group each expert takes at most
    ``min(max(int(capacity_factor * ng * k / e), 8), ng)`` tokens, in
    (expert, token) order, and the rest contribute 0. The buffers are
    (groups, experts, capacity, d), and the expert SwiGLU is three batched
    products over them.

    Deterministic on the card as on the CPU: top-k takes the lower expert
    index among equal probabilities (a stable sort, as `jax.lax.top_k`),
    and the combine adds each token's k expert outputs one after another
    in increasing expert id, the order in which the reference's
    scatter-add meets them, instead of an atomic scatter.

    Under a mesh x is split by batch and the experts over 'model'
    (`_moe_sharded`): the routing is the global one, and each rank runs its
    own experts on its own tokens.
    """
    if nn.is_sharded(x):
        return _moe_sharded(p, x, cfg)
    b, l, d = x.shape
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    n = b * l
    dev = x.device
    g_ = mo.dispatch_groups if n % max(mo.dispatch_groups, 1) == 0 else 1
    ng = n // g_  # tokens per dispatch group
    xn = rms_norm(x, p["norm"], cfg.norm_eps).reshape(g_, ng, d)
    xn = shard(xn, "batch", None, None)
    probs = torch.softmax(dense(xn, p["router"]).to(torch.float32), dim=-1)
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[..., :k], sel[..., :k]  # (g, ng, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    if ROUTING_LOG is not None:
        ROUTING_LOG.append(sel.reshape(b, l, k))
    cap = min(max(int(mo.capacity_factor * ng * k / e), 8), ng)
    flat_e = sel.reshape(g_, ng * k)
    flat_t = torch.arange(ng, device=dev).repeat_interleave(k).expand(g_, ng * k)
    flat_w = w.reshape(g_, ng * k).to(x.dtype)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # per group
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    starts = torch.searchsorted(se, torch.arange(e, device=dev).expand(g_, e).contiguous())
    rank = torch.arange(ng * k, device=dev)[None] - torch.gather(starts, 1, se)
    keep = rank < cap
    rankc = torch.clamp(rank, 0, cap - 1)
    gi = torch.arange(g_, device=dev)[:, None].expand(g_, ng * k)
    # a token past capacity lands on slot cap-1 times 0: added, not copied,
    # so the kept token there stays
    buf = torch.zeros((g_, e, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((gi, se, rankc), xn[gi, st] * keep[..., None].to(x.dtype), accumulate=True)
    buf = shard(buf, "batch", "experts", None, None)
    # expert FFN (batched over groups x experts)
    g = torch.einsum("xecd,edf->xecf", buf, p["w_gate"].to(x.dtype))
    u = torch.einsum("xecd,edf->xecf", buf, p["w_up"].to(x.dtype))
    hmid = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    hmid = shard(hmid, "batch", "experts", None, "mlp")
    eout = torch.einsum("xecf,efd->xecd", hmid, p["w_down"].to(x.dtype))
    eout = shard(eout, "batch", "experts", None, None)
    # combine: each token's k weighted outputs, taken back from the sorted
    # order and added in increasing expert id
    contrib = eout[gi, se, rankc] * (sw * keep.to(x.dtype))[..., None]  # sorted order
    back = torch.empty_like(order).scatter_(1, order, torch.arange(ng * k, device=dev).expand(g_, -1))
    # a token's k entries sit in the sorted order by increasing expert id
    at = torch.sort(back.reshape(g_, ng, k), dim=-1).values.reshape(g_, ng * k)
    parts = torch.gather(contrib, 1, at[..., None].expand(-1, -1, d)).reshape(g_, ng, k, d)
    y = torch.zeros((g_, ng, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + parts[:, :, j]
    y = shard(y, "batch", None, None)
    y = y.reshape(b, l, d)
    if mo.n_shared:
        sp = p["shared"]
        y = y + nn.swiglu(xn.reshape(b, l, d), sp["w_gate"], sp["w_up"], sp["w_down"])
    return y


# --- MoE under a mesh --------------------------------------------------------


def _moe_sizes(cfg: ModelConfig, n: int) -> tuple[int, int, int]:
    """(groups, tokens a group, capacity) of `n` tokens, as `apply_moe`."""
    mo = cfg.moe
    g_ = mo.dispatch_groups if n % max(mo.dispatch_groups, 1) == 0 else 1
    ng = n // g_
    return g_, ng, min(max(int(mo.capacity_factor * ng * mo.top_k / mo.n_experts), 8), ng)


def _route(probs: torch.Tensor, cfg: ModelConfig, span: tuple[int, int], n: int, gather=None):
    """Top-k routing of the tokens [t0, t1) of `n` (their router
    probabilities `probs` (t1 - t0, e), float32): (weights, experts, rank
    of each choice in its expert's queue). The rank is the one the whole
    dispatch group gives (`apply_moe`'s sort by (expert, token)): where
    the span holds whole groups it is taken from these tokens alone;
    otherwise `gather` gives every token's choices (n, k), the same on
    every rank, and each rank keeps its span's rows."""
    mo = cfg.moe
    e, k = mo.n_experts, mo.top_k
    _, ng, _ = _moe_sizes(cfg, n)
    t0, t1 = span
    w, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, sel = w[:, :k], sel[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    base, every = t0, sel
    if t0 % ng or t1 % ng:
        base, every = 0, gather(sel)
    flat_e = every.reshape(-1, ng * k)
    dev = sel.device
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(se, torch.arange(e, device=dev).expand(se.shape[0], e).contiguous())
    rank = torch.arange(ng * k, device=dev)[None] - torch.gather(starts, 1, se)
    rank = torch.empty_like(rank).scatter_(1, order, rank).reshape(-1, k)
    return w, sel, rank[t0 - base:t1 - base]


def _moe_layout(p: dict, x):
    """(mesh dims that split the batch, mesh dims that split the experts,
    the expert weights with every other split gathered) for `_moe_sharded`."""
    from torch.distributed.tensor import Replicate, Shard

    from ..runtime import sharding as rsh

    if not all(pl == Shard(0) or isinstance(pl, Replicate) for pl in x.placements):
        raise ValueError(f"the MoE takes activations split by batch only, got {x.placements}")
    rows = [j for j, pl in enumerate(x.placements) if pl == Shard(0)]
    ws = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = p[name]
        if not nn.is_sharded(w):
            raise TypeError("activations laid out on a mesh take expert weights laid out on it")
        # FSDP's 'embed' split gathered (its gradient reduce-scattered back);
        # the experts' own split over 'model' is kept
        ws[name] = rsh.redistribute(w, tuple(pl if pl == Shard(0) else Replicate()
                                             for pl in w.placements))
    experts = [j for j, pl in enumerate(ws["w_gate"].placements) if pl == Shard(0)]
    return rows, experts, ws


def moe_routing(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple:
    """(experts, kept): each token's k expert choices (B, L, k) and whether
    each was kept under the capacity (the rest contribute 0), as
    `apply_moe` routes them; for a DTensor `x`, laid out by its batch
    split (each rank's rows: the global routing)."""
    b, l, _ = x.shape
    k = cfg.moe.top_k
    if not nn.is_sharded(x):
        xn = rms_norm(x, p["norm"], cfg.norm_eps).reshape(b * l, -1)
        probs = torch.softmax(dense(xn, p["router"]).to(torch.float32), dim=-1)
        _, sel, rank = _route(probs, cfg, (0, b * l), b * l)
        return sel.reshape(b, l, k), (rank < _moe_sizes(cfg, b * l)[2]).reshape(b, l, k)
    _, sel, rank, _ = _moe_route_sharded(p, x, cfg)
    keep = rank < _moe_sizes(cfg, b * l)[2]
    from ..runtime import sharding as rsh

    lay = rsh.NamedSharding(x.device_mesh, tuple(x.placements))
    return tuple(rsh.from_local(t.reshape(-1, l, k), lay, (b, l, k)) for t in (sel, keep))


def _moe_route_sharded(p: dict, x, cfg: ModelConfig, xl=None, rl=None):
    """The routing of this rank's tokens of DTensor `x` (its rows' `_route`,
    the expert choices gathered over the batch's mesh dims where the
    groups straddle ranks): (weights, experts, ranks, (t0, t1)). `xl` and
    `rl` are the local normed activations and the whole router where the
    caller has them."""
    from torch.distributed.tensor import Replicate

    from ..runtime import sharding as rsh

    b, l, _ = x.shape
    n = b * l
    mesh = x.device_mesh
    if xl is None:
        xl = rms_norm(x, p["norm"], cfg.norm_eps).to_local().reshape(-1, x.shape[-1])
        rl = rsh.redistribute(p["router"], (Replicate(),) * mesh.ndim).to_local()
    start, stop = rsh.local_box(rsh.NamedSharding(mesh, tuple(x.placements)), tuple(x.shape))
    span = (start[0] * l, stop[0] * l)
    probs = torch.softmax(torch.matmul(xl, rl.to(xl.dtype)).to(torch.float32), dim=-1)

    def gather(sel):
        k = sel.shape[-1]
        local = sel.reshape(stop[0] - start[0], l, k)
        return rsh.gather_dim(local, mesh, tuple(x.placements), 0, b).reshape(n, k)

    w, sel, rank = _route(probs, cfg, span, n, gather)
    return w, sel, rank, span


def _moe_sharded(p: dict, x, cfg: ModelConfig):
    """`apply_moe` on DTensors: x split by batch, the experts over 'model'.

    The routing is the reference's global one (`_moe_route_sharded`:
    every rank computes its tokens' ranks in the whole dispatch group, so
    a rank drops exactly the tokens the unsharded block drops). Each rank
    then runs only its own experts' SwiGLU on its own tokens' kept
    choices, in a (groups, local experts, capacity, d) buffer at the
    slots the global routing gives them; no expert weight is gathered over
    'model' (FSDP's 'embed' split is, `_moe_layout`). The combine is a
    pending sum over the experts' mesh dims, formed and added in float32
    and rounded once (as `nn.dense` adds split products), so it adds the
    k outputs in another order than the unsharded block. Every local
    operand declares its gradient's layout: the activations' and the
    router's are pending over the experts' split, the weights' over the
    batch's."""
    from torch.distributed.tensor import Partial, Replicate

    from ..runtime import sharding as rsh

    b, l, d = x.shape
    k = cfg.moe.top_k
    dt = x.dtype
    mesh = x.device_mesh
    rows, experts, ws = _moe_layout(p, x)
    nm = mesh.ndim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    xl = xn.to_local(grad_placements=tuple(Partial() if j in experts else x.placements[j]
                                           for j in range(nm))).reshape(-1, d)
    rl = rsh.redistribute(p["router"], (Replicate(),) * nm).to_local(grad_placements=tuple(
        Partial() if j in rows or j in experts else Replicate() for j in range(nm)))
    w, sel, rank, (t0, t1) = _moe_route_sharded(p, x, cfg, xl, rl)
    if ROUTING_LOG is not None:
        ROUTING_LOG.append(rsh.from_local(sel.reshape(-1, l, k), rsh.layout_of(x), (b, l, k)))
    _, ng, cap = _moe_sizes(cfg, b * l)
    (e0,), (e1,) = (c[:1] for c in rsh.local_box(rsh.layout_of(ws["w_gate"]),
                                                 tuple(ws["w_gate"].shape)))
    e_loc = e1 - e0
    dev = xl.device
    mine = (rank < cap) & (sel >= e0) & (sel < e1)
    grp = (t0 + torch.arange(t1 - t0, device=dev)) // ng - t0 // ng
    n_grp = (t1 - 1) // ng - t0 // ng + 1
    nslot = n_grp * e_loc * cap
    # each kept choice of a local expert has its own slot; the rest go to
    # one spare slot past the buffer, which no output reads
    slot = (grp[:, None] * e_loc + (sel - e0)) * cap + torch.clamp(rank, 0, cap - 1)
    slot = torch.where(mine, slot, nslot).reshape(-1)
    src = xl[:, None, :].expand(-1, k, d).reshape(-1, d)
    buf = torch.zeros((nslot + 1, d), dtype=dt, device=dev).index_add(0, slot, src)
    buf = buf[:nslot].reshape(n_grp, e_loc, cap, d)
    wl = {name: w_.to_local(grad_placements=tuple(
        pl if j in experts else Partial() if j in rows else Replicate()
        for j, pl in enumerate(w_.placements))).to(dt) for name, w_ in ws.items()}
    g = torch.einsum("xecd,edf->xecf", buf, wl["w_gate"])
    u = torch.einsum("xecd,edf->xecf", buf, wl["w_up"])
    hmid = torch.nn.functional.silu(g.to(torch.float32)).to(dt) * u
    eout = torch.einsum("xecf,efd->xecd", hmid, wl["w_down"])
    eout = torch.cat([eout.reshape(nslot, d), eout.new_zeros(1, d)])
    contrib = eout[slot].reshape(-1, k, d) * (w.to(dt) * mine.to(dt))[..., None]
    y = contrib.to(torch.float32).sum(1).reshape(-1, l, d)
    pending = tuple(Partial() if j in experts else x.placements[j] for j in range(nm))
    y = nn.reduce_partial(rsh.from_local(y, rsh.NamedSharding(mesh, pending), (b, l, d))).to(dt)
    if cfg.moe.n_shared:
        sp = p["shared"]
        y = y + nn.swiglu(xn, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y
