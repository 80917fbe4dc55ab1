"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab=49152,
        mlp_type="swiglu",
    )
