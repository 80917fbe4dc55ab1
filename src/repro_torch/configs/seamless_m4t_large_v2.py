"""seamless-m4t-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

Audio frontend is a STUB (input_specs provides precomputed frame
embeddings); 24L encoder + 24L decoder with cross-attention."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,            # decoder
        n_enc_layers=24,        # encoder
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256206,
        mlp_type="swiglu",
        encdec=True,
        frontend="audio",
        frontend_len=1024,
    )
