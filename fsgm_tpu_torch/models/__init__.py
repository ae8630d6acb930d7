"""Pipelines of the PyTorch port."""
