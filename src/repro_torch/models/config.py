"""Model configuration dataclasses for the architecture zoo.

Port of `repro.models.config`: pure data, the same fields and defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    n_dense_layers: int = 0  # leading dense layers (deepseek-v2 style)
    # dispatch groups: >1 sorts/ranks tokens within per-group chunks that
    # align with the DP sharding, keeping the MoE dispatch shard-local
    # (GSPMD replicates a global argsort) — §Perf knob
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    m_per_group: int = 7   # mLSTM layers per group
    s_per_group: int = 1   # sLSTM layers per group
    proj_factor: float = 2.0
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """zamba2-style: shared attention block applied every `every` SSM layers."""

    every: int = 6
    concat_embed: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    mlp_type: str = "swiglu"  # swiglu | gelu | relu2
    head_dim: Optional[int] = None
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    hybrid: Optional[HybridCfg] = None
    encdec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None  # vision | audio (stub embeddings)
    frontend_len: int = 256
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # supports long_500k decode
    attn_window: Optional[int] = None  # sliding window (hybrid long mode)
    remat: bool = True  # activation-checkpoint each scanned layer (train)
    unroll_layers: bool = False  # python-loop layers (dry-run cost probes)
    kv_quant: bool = False  # int8 KV cache (paper Stage-II quantization)

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Shrink any config to CPU-smoke size, preserving the family topology."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        head_dim=32,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_shared=64 if cfg.moe.n_shared else 0,
        )
    if cfg.mla:
        kw["mla"] = MLACfg(q_lora=64, kv_lora=32, qk_nope=16, qk_rope=16, v_head=32)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state=16, head_dim=16, chunk=16)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, m_per_group=1, s_per_group=1, chunk=16)
        kw["n_layers"] = 4  # 2 groups x (1 mLSTM + 1 sLSTM)
    if cfg.hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, every=2)
        kw["n_layers"] = 5
    if cfg.encdec:
        kw["n_enc_layers"] = 2
    if cfg.frontend:
        kw["frontend_len"] = 16
    return cfg.scaled(**kw)
