"""repro_torch.launch — command-line drivers (`serve`), in PyTorch. The
reference's train, dry-run and multi-host launchers are not ported yet
(ROADMAP queue A items 11-14)."""
