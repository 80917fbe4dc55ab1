"""minitron-4b — pruned nemotron (squared-ReLU MLP) [arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=9216,
        vocab=256000,
        mlp_type="relu2",
    )
