"""repro_torch.launch — command-line drivers (`serve`, `train`), the mesh
builders (`mesh`), the multi-process job runner (`mhrun`), the
sharded-checkpoint dryrun (`shardckpt`) and the batch layout of the
dry-run launcher (`dryrun.batch_shardings`), in PyTorch. `serve` and
`train` run under a mesh in a job of more than one rank. The rest of the
dry-run launcher is ROADMAP queue A item 14d."""
