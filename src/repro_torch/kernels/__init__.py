"""Hand-written Hopper kernels (K1-K4) with their plain PyTorch versions."""
