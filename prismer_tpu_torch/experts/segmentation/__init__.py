"""Segmentation expert: Swin-L backbone + Mask2Former (PyTorch port)."""
