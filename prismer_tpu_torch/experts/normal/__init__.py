"""Surface-normal expert: NNET on EfficientNet-B5 (PyTorch port)."""
