"""repro_torch.runtime — the serving tier's KV page compression
(`kvcomp`) and the single-process runtime primitives the checkpoint manager
calls (`dist`), in PyTorch. The batcher, the multi-process part of `dist`
and the sharding module of the reference's runtime are not ported yet
(ROADMAP queue A items 13-14)."""

from . import dist, kvcomp  # noqa: F401
