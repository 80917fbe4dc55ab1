"""repro_torch.runtime — the serving tier's KV page compression
(`kvcomp`), in PyTorch. The batcher, distribution and sharding modules of
the reference's runtime are not ported yet (ROADMAP queue A items 13-14)."""

from . import kvcomp  # noqa: F401
