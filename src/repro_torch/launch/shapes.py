"""Assigned input-shape set and abstract input specs per (arch x shape), in
torch.

Port of `repro.launch.shapes`. LM transformer shapes are seq_len x
global_batch. decode_*/long_* run the serve step (one new token against a
KV cache of seq_len), NOT the train step. long_500k requires
sub-quadratic attention: runs for SSM/hybrid archs (xlstm, zamba2 — the
latter with a 4k sliding window on its shared attention block), skipped
for pure full-attention archs (DESIGN.md §6).

`FIELD_SHAPES` / `compression_view` are the compression-side counterpart:
the canonical scientific-field shapes of the paper's workloads, plus the
fold plan each will compress as (genuinely 3-D fields stay 3-D).

`input_specs` gives `models.nn.TensorSpec`s (shape and dtype, no storage)
where the reference gives `jax.ShapeDtypeStruct`s: the same keys, shapes
and dtypes (int32 tokens, float32 frontend stubs).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sharded import fold_plan
from ..models.config import ModelConfig
from ..models.nn import TensorSpec

SHAPES = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}

#: canonical scientific-field shapes per paper workload, CPU-bench scaled
#: (the *_full variants carry the real dataset dims)
FIELD_SHAPES = {
    "atm_2d": (384, 768),             # ATM climate plane (1800x3600 full)
    "hurricane_3d": (96, 256, 256),   # Hurricane volume (100x500x500 full)
    "nyx_3d": (128, 128, 128),        # NYX cosmology cube (512^3 full)
    "hurricane_full": (100, 500, 500),
    "nyx_full": (512, 512, 512),
}

I32 = torch.int32
F32 = torch.float32


def compression_view(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The folded view shape the selector and the kernel tier see for a
    field of `shape` (`core.sharded.fold_plan`): rank > 3 folds leading
    axes but never below 3-D, short (< 4) leading dims merge away."""
    return fold_plan(tuple(int(s) for s in shape))[0]


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attn)"
    return True, ""


def shape_config(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Per-shape config tweaks (windowed shared attention in long mode)."""
    if shape_name == "long_500k" and cfg.hybrid is not None:
        return dataclasses.replace(cfg, attn_window=4_096)
    return cfg


def _frontend(cfg: ModelConfig, b: int) -> dict:
    out = {}
    if cfg.frontend == "vision":
        out["patch_embeds"] = TensorSpec((b, cfg.frontend_len, cfg.d_model), F32)
    if cfg.encdec:
        out["frames"] = TensorSpec((b, cfg.frontend_len, cfg.d_model), F32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """`TensorSpec` stand-ins for every model input of this cell.

    Returns {'kind', 'global_batch', 'seq', 'batch': {...}} and, for
    prefill and decode, 'cache_len'. For train, batch = full (tokens,
    labels, frontend stubs). For prefill, batch = prompt tokens (+ stubs).
    For decode, tokens are (B, 1) and cache_len is the preallocated KV
    length (the window for a windowed hybrid at long_500k).
    """
    sh = SHAPES[shape_name]
    b, seq = sh["batch"], sh["seq"]
    kind = sh["kind"]
    out = {"kind": kind, "global_batch": b, "seq": seq}
    ltxt = seq - (cfg.frontend_len if cfg.frontend == "vision" else 0)
    if kind == "train":
        out["batch"] = {"tokens": TensorSpec((b, ltxt), I32), "labels": TensorSpec((b, ltxt), I32),
                        **_frontend(cfg, b)}
    elif kind == "prefill":
        out["batch"] = {"tokens": TensorSpec((b, ltxt), I32), **_frontend(cfg, b)}
        out["cache_len"] = seq
    else:  # decode
        out["batch"] = {"tokens": TensorSpec((b, 1), I32)}
        cache_len = seq
        if shape_name == "long_500k":
            cache_len = shape_config(cfg, shape_name).attn_window or 4_096
        out["cache_len"] = cache_len
    return out


__all__ = ["FIELD_SHAPES", "SHAPES", "applicable", "compression_view", "input_specs",
           "shape_config"]
