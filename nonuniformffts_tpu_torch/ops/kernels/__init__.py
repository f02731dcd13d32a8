"""Hand-written CUDA kernels (csrc/) and their Python wrappers."""
