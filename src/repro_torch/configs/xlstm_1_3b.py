"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517]. 48L, d=2048, 4H."""
from repro_torch.models.config import ModelConfig, XLSTMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,            # 6 groups x (7 mLSTM + 1 sLSTM)
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,                 # xLSTM blocks have no separate FFN
        vocab=50304,
        xlstm=XLSTMCfg(m_per_group=7, s_per_group=1, proj_factor=2.0, chunk=256),
        sub_quadratic=True,     # recurrent decode -> long_500k runs
    )
