"""OCR expert: CharNet on Hourglass-88 (PyTorch port)."""
