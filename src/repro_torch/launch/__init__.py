"""repro_torch.launch — command-line drivers (`serve`, `train`), the mesh
builders (`mesh`), the multi-process job runner (`mhrun`), the
sharded-checkpoint dryrun (`shardckpt`), and the dry-run launcher
(`dryrun`, with the cell shapes of `shapes`): every arch x shape cell
traced on the production meshes over a fake process group, in PyTorch.
`serve` and `train` run under a mesh in a job of more than one rank."""
