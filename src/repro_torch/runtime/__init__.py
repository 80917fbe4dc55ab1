"""repro_torch.runtime — the serving tier (the continuous `batcher` with its
paged KV pool, the prefill/decode `steps`, the KV page compression
`kvcomp`) and the single-process runtime primitives the checkpoint manager
calls (`dist`), in PyTorch. The train step, the multi-process part of
`dist` and the sharding module of the reference's runtime are not ported
yet (ROADMAP queue A items 11 and 14)."""

from . import dist, kvcomp  # noqa: F401
