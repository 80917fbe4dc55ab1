"""Transformer building blocks: GQA attention with its three decode caches,
and the dense MLPs, in torch.

Port of `repro.models.blocks`. Every block exposes `desc_*` (a
P-descriptor tree) and `apply_*` (plain torch). Decode caches are dicts
of tensors; `*_cache_desc` gives their `TensorSpec`s.

Decode caches are written IN PLACE: where the reference returns a
functionally updated array (`dynamic_update_slice`, `.at[].set`), the port
writes the new keys and values into the cache tensor it was given and
returns that same tensor. The caller keeps the returned cache and reads
no older copy.

MLA (`desc_mla`/`apply_mla`) and MoE (`desc_moe`/`apply_moe`) are not
ported yet (ROADMAP queue A item 12); they raise.
"""

from __future__ import annotations

import torch

from . import nn
from .config import ModelConfig
from .nn import P, TensorSpec, attention, dense, rms_norm, rope, shard

_TODO = "is not ported yet (ROADMAP queue A item 12: the MoE and MLA families)"


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
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention with an optional decode cache.

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
    q = dense(xn, p["wq"]).reshape(b, l, h, dh)
    k = dense(xn, p["wk"]).reshape(b, l, hkv, dh)
    v = dense(xn, p["wv"]).reshape(b, l, hkv, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "heads", None)
    v = shard(v, "batch", None, "heads", None)
    new_cache = None
    if cache is not None and "ptab" in cache:
        # --- paged KV pool (serving tier, DESIGN.md §9) ---
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
            ck.index_copy_(1, rows, k.to(ck.dtype))
            cv.index_copy_(1, rows, v.to(cv.dtype))
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
# MLA and MoE (not ported yet)
# ---------------------------------------------------------------------------


def desc_mla(cfg: ModelConfig) -> dict:
    raise NotImplementedError(f"MLA attention {_TODO}")


def apply_mla(p, x, positions, cfg, *, cache=None):
    raise NotImplementedError(f"MLA attention {_TODO}")


def desc_moe(cfg: ModelConfig) -> dict:
    raise NotImplementedError(f"the MoE block {_TODO}")


def apply_moe(p, x, cfg):
    raise NotImplementedError(f"the MoE block {_TODO}")


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
