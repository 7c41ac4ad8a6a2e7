"""Depth expert: DPT-hybrid (PyTorch port)."""
