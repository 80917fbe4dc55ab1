"""repro_torch.runtime — the train and serve step builders (`steps`: the
train step with gradient compression and AdamW, prefill and decode), the
serving tier (the continuous `batcher` with its paged KV pool, the KV page
compression `kvcomp`) and the single-process runtime primitives the
checkpoint manager calls (`dist`), in PyTorch. The multi-process part of
`dist` and the sharding module of the reference's runtime are not ported
yet (ROADMAP queue A item 14)."""

from . import dist, kvcomp  # noqa: F401
