"""PyTorch + CUDA port of prismer_tpu (see README, "PyTorch/CUDA port")."""
