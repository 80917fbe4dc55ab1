"""repro_torch.data — the deterministic synthetic data pipeline (port of
`repro.data`; numpy only)."""

from .pipeline import DataConfig, make_batch_iterator, read_binary_corpus, synthetic_batch

__all__ = ["DataConfig", "make_batch_iterator", "read_binary_corpus", "synthetic_batch"]
