"""Object-detection expert: UniDet on ResNeSt-200 (PyTorch port)."""
