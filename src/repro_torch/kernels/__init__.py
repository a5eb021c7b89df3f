"""Hand-written CUDA attention kernels and their plain PyTorch versions."""
