"""Hand-written CUDA kernels of the package, their build, and their plain
PyTorch versions."""
