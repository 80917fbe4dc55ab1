"""repro_torch.launch — command-line drivers (`serve`, `train`), in
PyTorch. The reference's dry-run and multi-host launchers are not ported
yet (ROADMAP queue A item 14)."""
