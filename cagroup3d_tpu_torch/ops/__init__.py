"""Hand-written CUDA kernels (K1 sparse conv, K2 segment sum) with their
plain PyTorch versions and wrappers."""
