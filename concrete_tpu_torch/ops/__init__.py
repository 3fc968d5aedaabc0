"""Build and launch of the port's hand-written CUDA kernels."""
