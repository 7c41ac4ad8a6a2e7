"""Command-line drivers: python -m prismer_tpu_torch.cli.<name>."""
