"""Edge expert: DexiNed (PyTorch port)."""
