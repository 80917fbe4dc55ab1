"""llama4-scout-17b-16e — MoE 16 experts top-1 + shared [hf:meta-llama]."""
from repro_torch.models.config import ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1, d_ff_shared=8192),
    )
