"""Expert kernel wrappers (CUDA on the card, plain PyTorch on the CPU)."""
