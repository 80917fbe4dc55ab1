"""The port's kernel tier: CUDA kernels for Hopper (built from ``csrc/`` at
first use), their plain torch versions, and the torch word-arena packer."""
