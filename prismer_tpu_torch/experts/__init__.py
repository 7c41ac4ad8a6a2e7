"""Label experts (PyTorch port of prismer_tpu.experts)."""
