"""Image ops: the plain PyTorch versions and the CUDA kernel wrappers."""
