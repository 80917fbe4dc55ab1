"""repro_torch.launch — command-line drivers (`serve`, `train`), the mesh
builders (`mesh`), the multi-process job runner (`mhrun`) and the
sharded-checkpoint dryrun (`shardckpt`), in PyTorch. The reference's
dry-run launcher and the mesh rules of `serve`/`train` are ROADMAP queue A
item 14b."""
