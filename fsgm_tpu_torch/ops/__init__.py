"""Operators of the PyTorch port; the hand-written kernels are in ops.kernels."""
