"""internvl2-76b — InternViT + InternLM2 backbone [arXiv:2404.16821].

VLM: the vision frontend is a STUB (input_specs provides precomputed patch
embeddings); this config is the 80L InternLM2-based language backbone."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        mlp_type="swiglu",
        frontend="vision",
        frontend_len=256,
    )
