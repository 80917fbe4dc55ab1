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
                "the paged KV pool under a mesh: ROADMAP.md queue A, item 14e")
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
        if "k_scale" in cache and nn.is_sharded(q):
            raise NotImplementedError(
                "the int8 KV cache under a mesh: ROADMAP.md queue A, item 14e")
        if "k_scale" in cache:
            # int8 KV cache: per-(token, head) linear quantization (the
            # paper's Stage-II vector quantization applied to KV residency)
            ks = torch.amax(torch.abs(k), dim=-1).to(torch.float32) / 127.0 + 1e-12
            vs = torch.amax(torch.abs(v), dim=-1).to(torch.float32) / 127.0 + 1e-12
            kq = torch.round(k.to(torch.float32) / ks[..., None]).to(torch.int8)
            vq = torch.round(v.to(torch.float32) / vs[..., None]).to(torch.int8)
            cks, cvs = cache["k_scale"], cache["v_scale"]
            ck.index_copy_(1, rows, kq)
            cv.index_copy_(1, rows, vq)
            cks.index_copy_(1, rows, ks)
            cvs.index_copy_(1, rows, vs)
            new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs, "len": pos + l}
            k_all = ck.to(q.dtype) * cks[..., None].to(q.dtype)
            v_all = cv.to(q.dtype) * cvs[..., None].to(q.dtype)
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
    """
    b, l, d = x.shape
    h = cfg.n_heads
    m: MLACfg = cfg.mla
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    q = dense(rms_norm(dense(xn, p["wq_a"]), p["q_norm"], cfg.norm_eps), p["wq_b"])
    q = q.reshape(b, l, h, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., : m.qk_nope], q[..., m.qk_nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv_a = dense(xn, p["wkv_a"])
    c_kv, k_rope = kv_a[..., : m.kv_lora], kv_a[..., m.kv_lora:]
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # (B, L, 1, r)
    if cache is not None:
        # --- absorbed MLA decode: score and contract in the latent space ---
        pos = cache["len"]
        cc, cr = cache["ckv"], cache["krope"]
        mcap = cc.shape[1]
        rows = torch.clamp(pos, min=0, max=mcap - l).long() + torch.arange(l, device=x.device)
        cc.index_copy_(1, rows, c_kv.to(cc.dtype))
        cr.index_copy_(1, rows, k_rope[:, :, 0, :].to(cr.dtype))
        new_cache = {"ckv": cc, "krope": cr, "len": pos + l}
        c_all = rms_norm(cc.to(x.dtype), p["kv_norm"], cfg.norm_eps)  # (B, M, r)
        kr_all = cr.to(x.dtype)  # (B, M, rope)
        kv_len = pos + l
        wkv = p["wkv_b"].reshape(m.kv_lora, h, m.qk_nope + m.v_head).to(x.dtype)
        w_uk, w_uv = wkv[..., : m.qk_nope], wkv[..., m.qk_nope:]
        q_lat = torch.einsum("blhn,rhn->blhr", q_nope, w_uk)  # absorb W_uk
        q_lat = shard(q_lat, "batch", None, "heads", None)
        scale = 1.0 / math.sqrt(m.qk_nope + m.qk_rope)
        logits = (
            torch.einsum("blhr,bmr->bhlm", q_lat, c_all)
            + torch.einsum("blhr,bmr->bhlm", q_rope, kr_all)
        ).to(torch.float32) * scale
        qpos = torch.arange(l, device=x.device)[:, None] + pos
        kpos = torch.arange(mcap, device=x.device)[None, :]
        mask = (kpos <= qpos) & (kpos < kv_len)
        logits = torch.where(mask[None, None], logits, -1e30)
        wts = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhlm,bmr->blhr", wts, c_all)
        out = torch.einsum("blhr,rhv->blhv", ctx, w_uv)  # deferred W_uv
        return dense(out.reshape(b, l, h * m.v_head), p["wo"]), new_cache
    # --- parallel path (train / no cache): materialized K/V ---
    kv = dense(rms_norm(c_kv, p["kv_norm"], cfg.norm_eps), p["wkv_b"])
    kv = kv.reshape(b, l, h, m.qk_nope + m.v_head)
    k_nope, v = kv[..., : m.qk_nope], kv[..., m.qk_nope:]
    k = torch.cat([k_nope, k_rope.expand(b, l, h, m.qk_rope)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    qq = shard(qq, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    out = attention(qq, k, v, causal=True)  # scaled by 1/sqrt(qk_nope + qk_rope)
    return dense(out.reshape(b, l, h * m.v_head), p["wo"]), None


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
    """
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
