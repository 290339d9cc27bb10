"""Hand-written CUDA kernels for Hopper, their build helper, wrappers and
plain PyTorch versions."""
