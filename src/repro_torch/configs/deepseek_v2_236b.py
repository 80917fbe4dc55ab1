"""deepseek-v2-236b — MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE
[arXiv:2405.04434]."""
from repro_torch.models.config import MLACfg, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,            # the single leading dense layer's FFN
        vocab=102400,
        head_dim=128,
        mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
        moe=MoECfg(
            n_experts=160, top_k=6, d_ff_expert=1536,
            n_shared=2, d_ff_shared=3072, n_dense_layers=1,
        ),
    )
