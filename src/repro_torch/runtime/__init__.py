"""repro_torch.runtime — the train and serve step builders (`steps`: the
train step with gradient compression and AdamW, prefill and decode), the
serving tier (the continuous `batcher` with its paged KV pool, the KV page
compression `kvcomp`), the process runtime of the multi-host protocol
(`dist`) and the layout rules of a mesh (`sharding`), in PyTorch. Compute
under a mesh (`sharding.activate`, `cache_sharding`) is ROADMAP queue A
item 14b."""

from . import dist, kvcomp  # noqa: F401
