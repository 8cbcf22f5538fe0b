"""Hand-written CUDA kernels: build, load, wrappers."""
