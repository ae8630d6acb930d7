"""Measurement helpers of the PyTorch port."""
