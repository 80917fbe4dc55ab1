"""starcoder2-7b — GQA, RoPE, GELU MLP [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        d_ff=18432,
        vocab=49152,
        mlp_type="gelu",
    )
