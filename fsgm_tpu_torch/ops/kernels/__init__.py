"""Hand-written Hopper kernels (csrc/*.cu), each beside its plain PyTorch version."""
