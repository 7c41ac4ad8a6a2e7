"""Prismer model modules (PyTorch port of prismer_tpu.models)."""
