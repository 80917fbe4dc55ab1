"""zamba2-1.2b — Mamba2 backbone + shared attention [arXiv:2411.15242]."""
from repro_torch.models.config import HybridCfg, ModelConfig, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,            # 6 groups x 6 mamba + shared attn, +2 tail
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        ssm=SSMCfg(state=64, head_dim=64, expand=2, conv=4, chunk=256),
        hybrid=HybridCfg(every=6, concat_embed=True),
        sub_quadratic=True,     # SSM decode; shared attn windowed in long mode
        attn_window=None,       # set to 4096 by the long_500k shape
    )
